"""Memory and time of the port's test files, and worker time by file.

    python tests/measure_port_files.py files [FILE ...] [--json OUT]
        runs each test file alone (`python -m pytest FILE -q`, JAX on the
        CPU; by default every tests/test_torch_port_*.py) and prints its wall
        time and the peak resident memory of its process tree (pytest and
        every process it spawns, summed; sampled every 0.2 s from /proc) beside
        the largest single process's, highest peak first
    python tests/measure_port_files.py junit RUN.xml [--top N]
        prints the seconds each test file took in a JUnit XML report of a
        pytest run, summed over its tests (under xdist: worker time, fixture
        set-up included), the largest first, and the port files' total

Linux only (/proc). It measures; it asserts nothing.
"""

import argparse
import collections
import json
import os
import subprocess
import sys
import time
import xml.etree.ElementTree as ET
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PAGE = os.sysconf("SC_PAGE_SIZE")


def _tree_rss(root_pid):
    """(sum, largest) resident bytes of root_pid and its descendants."""
    children = collections.defaultdict(list)
    rss = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        pid = int(entry)
        children[int(fields[1])].append(pid)
        rss[pid] = int(fields[21]) * PAGE
    total, largest, todo = 0, 0, [root_pid]
    while todo:
        pid = todo.pop()
        total += rss.get(pid, 0)
        largest = max(largest, rss.get(pid, 0))
        todo.extend(children.get(pid, ()))
    return total, largest


def measure(path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "pytest", str(path), "-q",
                             "-p", "no:cacheprovider", "-p", "no:randomly"],
                            cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    peak_sum = peak_one = 0
    while proc.poll() is None:
        total, largest = _tree_rss(proc.pid)
        peak_sum, peak_one = max(peak_sum, total), max(peak_one, largest)
        time.sleep(0.2)
    wall = time.perf_counter() - t0
    lines = proc.stdout.read().strip().splitlines()
    return {"file": str(path), "wall_s": round(wall, 1), "peak_tree_gb": peak_sum / 1e9,
            "peak_process_gb": peak_one / 1e9, "rc": proc.returncode,
            "summary": lines[-1] if lines else ""}


def files(paths, out):
    paths = paths or sorted(REPO.glob("tests/test_torch_port_*.py"))
    rows = []
    for path in paths:
        rows.append(measure(path))
        r = rows[-1]
        print(f"{r['peak_tree_gb']:6.2f} GB tree {r['peak_process_gb']:6.2f} GB process "
              f"{r['wall_s']:7.1f} s  {Path(r['file']).name}: {r['summary']}", flush=True)
    print("highest peak first:")
    for r in sorted(rows, key=lambda r: -r["peak_tree_gb"]):
        print(f"| {Path(r['file']).name} | {r['peak_tree_gb']:.2f} | "
              f"{r['peak_process_gb']:.2f} | {r['wall_s']:.1f} | {r['summary']} |")
    if out:
        Path(out).write_text(json.dumps(rows, indent=1))


def junit(path, top):
    seconds, tests = collections.Counter(), collections.Counter()
    for case in ET.parse(path).getroot().iter("testcase"):
        name = case.get("classname", "").replace(".", "/") + ".py"
        seconds[name] += float(case.get("time", 0))
        tests[name] += 1
    port = sum(v for k, v in seconds.items() if "test_torch_port_" in k)
    print(f"all files {sum(seconds.values()):.1f} s; the port's {port:.1f} s")
    for name, s in seconds.most_common(top):
        print(f"{s:8.1f} s {tests[name]:4d} tests  {name}")


def main(argv):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="mode", required=True)
    f = sub.add_parser("files")
    f.add_argument("paths", nargs="*")
    f.add_argument("--json", default=None)
    j = sub.add_parser("junit")
    j.add_argument("xml")
    j.add_argument("--top", type=int, default=20)
    args = parser.parse_args(argv)
    if args.mode == "files":
        files(args.paths, args.json)
    else:
        junit(args.xml, args.top)


if __name__ == "__main__":
    main(sys.argv[1:])
