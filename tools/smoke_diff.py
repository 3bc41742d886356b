"""Compare the agreement values of two ``chip_smoke.py`` logs.

    python -m tools.smoke_diff PARENT.log CHANGE.log

Reads each log's ``# phase N ...: {json}`` lines (every phase but 0,
the build's), flattens
each phase's JSON into ``phase/key/...`` paths and prints, per phase, how
many values both logs have, which of them differ, and the paths only one
log has. Timings and what follows from them (``ms``, ``plain_ms``,
``library_ms``, ``wall_s``, ``bound_share``, ``us_per_iteration``) are
left out: they differ from run to run. Everything else (flags, counts,
errors, launches, iterations, bounds computed from iterations) is an
agreement value that an unchanged kernel must reproduce exactly.
"""

import json
import re
import sys

TIMING = {"ms", "plain_ms", "library_ms", "wall_s", "bound_share",
          "us_per_iteration"}


def _phases(path):
    out = {}
    with open(path) as f:
        for line in f:
            m = re.match(r"# phase (\d+) [^{]*?: (\{.*\})\s*$", line)
            if m and m[1] != "0":
                out[int(m[1])] = json.loads(m[2])
    return out


def _flatten(obj, prefix=""):
    if isinstance(obj, dict):
        for k, v in obj.items():
            if k in TIMING or k.startswith(("ms_", "plain_ms_",
                                            "library_ms_")):
                continue
            yield from _flatten(v, "%s/%s" % (prefix, k))
    else:
        yield prefix, obj


def main(argv=None) -> None:
    parent, change = (_phases(p) for p in (argv or sys.argv[1:]))
    for ph in sorted(set(parent) | set(change)):
        a = dict(_flatten(parent.get(ph, {})))
        b = dict(_flatten(change.get(ph, {})))
        both = sorted(set(a) & set(b))
        diff = [k for k in both if a[k] != b[k]]
        print("phase %d: %d values in both, %d differ" % (ph, len(both),
                                                          len(diff)))
        for k in diff:
            print("  differs %s: %r -> %r" % (k, a[k], b[k]))
        for k in sorted(set(a) ^ set(b)):
            print("  only in %s: %s" % ("parent" if k in a else "change", k))


if __name__ == "__main__":
    main()
