"""Serve the dense control phase of ``chip_smoke.py`` from several trees, in
turns, on one GPU.

Usage (from the repository root, on the H100)::

    git archive <commit> | tar -x -C build/parent
    python3 serve_ab.py build/parent . .+flight .+flight . build/parent

Each argument is a tree holding ``chip_smoke.py`` and its package, run in
a process of its own (the packages share a name) in the order given, so
list them in turns (parent, change, change, parent). ``+flight`` turns the
flight recorder on for that run (``LANGSTREAM_FLIGHT_DIR`` under the
tree's ``build/``); without it the recorder is off. Each run builds the
tree's kernels (into its own ``build/kernels``, kept for its later runs)
and serves ``chip_smoke.serve_dense_and_check`` at ``CONTROL_LAYERS``:
the mixed-length burst and the uniform 64-token burst. The last line is a
JSON list of each run's tok/s and mean TTFT, beside the card's name and
power limit.
"""

import json
import os
import subprocess
import sys

RUN = (
    "import json, chip_smoke as cs\n"
    "from langstream_tpu_torch.ops import _build\n"
    "_build.build_all()\n"
    "r = cs.serve_dense_and_check(cs.card_label(), layers=cs.CONTROL_LAYERS)\n"
    "print('AB ' + json.dumps({k: r[k] for k in ('tok_s', 'uniform_tok_s', 'ttft_ms', "
    "'uniform_ttft_ms')}), flush=True)\n"
)


def main() -> None:
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    label = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           check=True, capture_output=True, text=True).stdout.strip()
    results = []
    for spec in sys.argv[1:]:
        tree, _, flag = spec.partition("+")
        env = dict(os.environ)
        env.pop("LANGSTREAM_FLIGHT_DIR", None)
        if flag == "flight":
            env["LANGSTREAM_FLIGHT_DIR"] = os.path.join(os.path.abspath(tree), "build", "flight")
        out = subprocess.run([sys.executable, "-c", RUN], cwd=tree, env=env, capture_output=True,
                             text=True, timeout=900)
        lines = [line for line in out.stdout.splitlines() if line.startswith("AB ")]
        if out.returncode != 0 or not lines:
            sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
            sys.exit(f"serve_ab: {spec} failed (exit {out.returncode})")
        row = dict(json.loads(lines[-1][3:]), run=spec)
        print(json.dumps(row), flush=True)
        results.append(row)
    print(label)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
