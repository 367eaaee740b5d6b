"""Replay a tier-1 run's junit durations through pytest-xdist's loadfile
scheduler and print the wall it gives.

    python3 scripts/replay_loadfile_schedule.py run.xml [-n 6]
        [--without MOD,...] [--split MOD,... --at-most K]
        [--cut MOD=N1,N2,...] [--startup S]
        [--noise SIGMA --draws N --seed K --limit SECONDS]
        [--passes]

The scheduler (xdist's LoadScopeScheduling with its default reorder) queues
the test files by their number of tests, most first, files of one count in
collection order (by name); each worker takes one file, then another
whenever at most 2 of its tests are left. Each test's junit time (setup,
call and teardown) is replayed in that order, after --startup seconds of
collection. --without drops modules (by name, e.g. test_torch_ppg);
--split cuts the named modules into files of at most K tests, --cut one
module into files of the given sizes, in test order, to see where the
scheduler would run them. Prints the wall, each worker's busy seconds and
the files each worker ran. With --noise, each of --draws replays scales
every test by its own log-normal factor exp(SIGMA·z) and the wall's
median, 90th percentile and share past --limit are printed instead.
--passes adds the median and the least number of tests that passed in the
junit and finish within --limit (what a run cut there counts).
"""

import argparse
import collections
import random
import statistics
import xml.etree.ElementTree as ET


def load(path, passed=None):
    """Each module's test times in order; with a dict ``passed``, fill it
    with each module's per-test pass flags (no failure, error or skip)."""
    files = collections.OrderedDict()
    for tc in ET.parse(path).getroot().iter("testcase"):
        files.setdefault(tc.get("classname"), []).append(
            float(tc.get("time")))
        if passed is not None:
            passed.setdefault(tc.get("classname"), []).append(
                not any(c.tag in ("failure", "error", "skipped")
                        for c in tc))
    return files


def replay(files, n_workers, startup=0.0, noise=0.0, rng=None, ends=None):
    """The workers' end times and the files each ran; with a list ``ends``,
    append (module, test index, finish time) for every test."""
    queue = collections.deque(
        sorted(sorted(files), key=lambda name: -len(files[name])))
    pend = [collections.deque() for _ in range(n_workers)]
    ran = [[] for _ in range(n_workers)]
    t = [startup] * n_workers

    def take(i):
        if queue:
            name = queue.popleft()
            for j, x in enumerate(files[name]):
                pend[i].append((name, j, x * rng.lognormvariate(0.0, noise)
                                if noise else x))
            ran[i].append(name)

    for i in range(n_workers):
        take(i)
    for i in range(n_workers):
        if len(pend[i]) <= 2:
            take(i)
    while True:
        ready = [(t[i], i) for i in range(n_workers) if pend[i]]
        if not ready:
            break
        _, i = min(ready)
        name, j, x = pend[i].popleft()
        t[i] += x
        if ends is not None:
            ends.append((name, j, t[i]))
        if len(pend[i]) <= 2:
            take(i)
    return t, ran


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("junit")
    ap.add_argument("-n", type=int, default=6)
    ap.add_argument("--without", default="")
    ap.add_argument("--split", default="")
    ap.add_argument("--at-most", type=int, default=3)
    ap.add_argument("--cut", action="append", default=[])
    ap.add_argument("--startup", type=float, default=0.0)
    ap.add_argument("--noise", type=float, default=0.0)
    ap.add_argument("--draws", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--limit", type=float, default=1470.0)
    ap.add_argument("--passes", action="store_true")
    a = ap.parse_args()
    drop = set(filter(None, a.without.split(",")))
    split = set(filter(None, a.split.split(",")))
    sizes = {mod: [int(n) for n in ns.split(",")]
             for mod, ns in (c.split("=") for c in a.cut)}
    files = collections.OrderedDict()
    passed, flags = {}, {}
    for name, times in load(a.junit, passed).items():
        mod = name.split(".")[-1]
        if mod in drop:
            continue
        if mod in split:
            for j in range(0, len(times), a.at_most):
                files[f"{name}[{j}]"] = times[j:j + a.at_most]
                flags[f"{name}[{j}]"] = passed[name][j:j + a.at_most]
        elif mod in sizes:
            assert sum(sizes[mod]) == len(times), (mod, len(times))
            j = 0
            for k, n in enumerate(sizes[mod]):
                files[f"{name}[{k}]"] = times[j:j + n]
                flags[f"{name}[{k}]"] = passed[name][j:j + n]
                j += n
        else:
            files[name] = times
            flags[name] = passed[name]
    total = sum(sum(v) for v in files.values())
    def passes_by_limit(ends):
        return sum(flags[name][j] for name, j, end in ends if end <= a.limit)

    if a.noise:
        rng = random.Random(a.seed)
        walls, counts = [], []
        for _ in range(a.draws):
            ends = [] if a.passes else None
            walls.append(max(replay(files, a.n, a.startup, a.noise, rng,
                                    ends)[0]))
            if a.passes:
                counts.append(passes_by_limit(ends))
        walls.sort()
        print(f"median {statistics.median(walls):.1f} s; p90 "
              f"{walls[int(0.9 * a.draws)]:.1f} s; past {a.limit:.0f} s "
              f"{sum(w > a.limit for w in walls) / a.draws:.3f} of "
              f"{a.draws} draws; sum {total:.1f} s")
        if a.passes:
            print(f"passes within {a.limit:.0f} s: median "
                  f"{statistics.median(counts):.0f}, least {min(counts)} of "
                  f"{sum(sum(v) for v in flags.values())}")
        return
    t, ran = replay(files, a.n, a.startup)
    print(f"wall {max(t):.1f} s; workers {[round(x, 1) for x in t]}; "
          f"sum {total:.1f} s")
    for i, names in enumerate(ran):
        print(f"worker {i}: {' '.join(n.split('.')[-1] for n in names)}")


if __name__ == "__main__":
    main()
