"""Replay a tier-1 run's junit durations through pytest-xdist's loadfile
scheduler and print the wall it gives.

    python3 scripts/replay_loadfile_schedule.py run.xml [-n 6]
        [--without MOD,...] [--split MOD,... --at-most K]

The scheduler (xdist's LoadScopeScheduling with its default reorder) queues
the test files by their number of tests, most first; each worker takes
one file, then another whenever at most 2 of its tests are left. Each
test's junit time (setup, call and teardown) is replayed in that order.
--without drops modules (by name, e.g. test_torch_ppg); --split cuts the
named modules into files of at most K tests, to see where the scheduler
would run them. Prints the wall, each worker's busy seconds and the files
each worker ran.
"""

import argparse
import collections
import xml.etree.ElementTree as ET


def load(path):
    files = collections.OrderedDict()
    for tc in ET.parse(path).getroot().iter("testcase"):
        files.setdefault(tc.get("classname"), []).append(
            float(tc.get("time")))
    return files


def replay(files, n_workers):
    queue = sorted(files.items(), key=lambda kv: -len(kv[1]))
    pend = [[] for _ in range(n_workers)]
    idx = [0] * n_workers
    t = [0.0] * n_workers

    def take(i):
        if queue:
            name, times = queue.pop(0)
            pend[i] += [(name, x) for x in times]

    for i in range(n_workers):
        take(i)
    for i in range(n_workers):
        if len(pend[i]) <= 2:
            take(i)
    while True:
        ready = [(t[i], i) for i in range(n_workers) if idx[i] < len(pend[i])]
        if not ready:
            break
        _, i = min(ready)
        t[i] += pend[i][idx[i]][1]
        idx[i] += 1
        if len(pend[i]) - idx[i] <= 2:
            take(i)
    return t, pend


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("junit")
    ap.add_argument("-n", type=int, default=6)
    ap.add_argument("--without", default="")
    ap.add_argument("--split", default="")
    ap.add_argument("--at-most", type=int, default=3)
    a = ap.parse_args()
    drop = set(filter(None, a.without.split(",")))
    cut = set(filter(None, a.split.split(",")))
    files = collections.OrderedDict()
    for name, times in load(a.junit).items():
        mod = name.split(".")[-1]
        if mod in drop:
            continue
        if mod in cut:
            for j in range(0, len(times), a.at_most):
                files[f"{name}[{j}]"] = times[j:j + a.at_most]
        else:
            files[name] = times
    t, pend = replay(files, a.n)
    print(f"wall {max(t):.1f} s; workers {[round(x, 1) for x in t]}; "
          f"sum {sum(sum(v) for v in files.values()):.1f} s")
    for i, p in enumerate(pend):
        names = list(dict.fromkeys(name.split(".")[-1] for name, _ in p))
        print(f"worker {i}: {' '.join(names)}")


if __name__ == "__main__":
    main()
