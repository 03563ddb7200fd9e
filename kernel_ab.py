"""Time B1 and B4 of several trees of the port on one card, in turns.

Run on the GPU machine from the repository root, with each tree given as
a directory that holds a ``langstream_tpu_torch`` package, for example
the parent commit unpacked beside this one with ``git archive`` into a
git-ignored directory::

    python3 kernel_ab.py build/parent . . build/parent

Each argument is timed in a process of its own (two packages of one name
cannot share a process), with this tree's ``chip_smoke.py`` checks: the
kernel is held against its plain version and timed beside SDPA and its
bound at the kernels line's two shapes. One JSON line per run is printed,
then the card's name and power limit. Compare trees only within one run.
"""

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
print(json.dumps([smoke.check_prefill_kernel(device, quant) for quant in (False, True)]))
"""


def run(tree: str) -> list:
    root = os.path.abspath(tree)
    out = subprocess.run([sys.executable, "-c", CHILD, root, HERE], check=True,
                         capture_output=True, text=True, timeout=600).stdout
    return json.loads(out.strip().splitlines()[-1])


def main() -> None:
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    for tree in sys.argv[1:]:
        entries = run(tree)
        print(json.dumps({"tree": tree, "kernels": [
            {key: entry[key] for key in FIELDS} for entry in entries]}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
