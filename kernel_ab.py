"""Time the flash kernels of several trees of the port on one card, in
turns: B1 and B4 (prefill), B2 and B5 (decode), or all four.

Run on the GPU machine from the repository root, with each tree given as
a directory that holds a ``langstream_tpu_torch`` package, for example
the parent commit unpacked beside this one with ``git archive`` into a
git-ignored directory::

    python3 kernel_ab.py build/parent . . build/parent
    python3 kernel_ab.py --checks decode build/parent . . build/parent

``--checks`` takes ``prefill``, ``decode`` or ``prefill,decode`` (the
default). Each tree is timed in a process of its own (two packages of one
name cannot share a process), with this tree's ``chip_smoke.py`` checks:
each kernel is held against its plain version and timed beside SDPA and
its bound at the kernels line's shapes. Each run prints the checks' own
lines (errors, times, B2/B5 at T 4096), indented and led by the tree,
then one JSON line; the card's name and power limit come last. Compare
trees only within one run.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
FIELDS = ("name", "ms", "long_ms", "library_ms", "long_library_ms", "max_abs_err",
          "long_max_abs_err")

# run inside the child, with the tree under test first on sys.path
CHILD = """
import importlib.util, json, os, sys
root, here = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
import langstream_tpu_torch
found = os.path.dirname(os.path.dirname(os.path.abspath(langstream_tpu_torch.__file__)))
assert found == root, (found, root)
spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(here, "chip_smoke.py"))
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
import torch
device = torch.device("cuda")
checks = [getattr(smoke, f"check_{name}_kernel") for name in sys.argv[3].split(",")]
print(json.dumps([check(device, quant) for check in checks for quant in (False, True)]))
"""
CHECKS = ("prefill", "decode")


def run(tree: str, checks: str) -> list:
    root = os.path.abspath(tree)
    out = subprocess.run([sys.executable, "-c", CHILD, root, HERE, checks], check=True,
                         capture_output=True, text=True, timeout=600).stdout
    lines = out.strip().splitlines()
    for line in lines[:-1]:  # the checks' own lines: errors, times, the T 4096 decode time
        if line.startswith("B"):
            print(f"  {tree}: {line}", flush=True)
    return json.loads(lines[-1])


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--checks", default=",".join(CHECKS),
                        help="comma-separated: prefill, decode (default both)")
    parser.add_argument("trees", nargs="+", help="directories that hold langstream_tpu_torch")
    args = parser.parse_args()
    names = args.checks.split(",")
    if not names or any(name not in CHECKS for name in names):
        parser.error(f"--checks takes a comma-separated subset of {CHECKS}")
    for tree in args.trees:
        entries = run(tree, args.checks)
        print(json.dumps({"tree": tree, "kernels": [
            {key: entry[key] for key in FIELDS if key in entry} for entry in entries]}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
