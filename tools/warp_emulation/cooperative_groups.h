// Declarations only, so ip_tile.cuh parses on the host (its tile solve is
// not instantiated by tools/warp_emulation.py).
#pragma once
namespace cooperative_groups {
template <unsigned W, typename P = void>
struct thread_block_tile {
  unsigned thread_rank() const;
  void sync() const;
  template <class T> T shfl(T, int) const;
  template <class T> T shfl_xor(T, int) const;
};
}  // namespace cooperative_groups
