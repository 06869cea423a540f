"""Registers, spills and SASS instruction counts of every kernel a CUDA
source compiles to, optionally beside the same source of another tree.

    python -m repro_torch.kernels.sass_report knn.cu \
        [--against OTHER_CSRC [--rename PATTERN REPLACEMENT]]

Compiles ``csrc/<source>`` (and ``OTHER_CSRC/<source>``) with the build's
nvcc flags into a cubin, reads ptxas's ``-v`` report (registers, spill
stores and loads per kernel) and counts the instructions ``cuobjdump
-sass`` lists per kernel, under its demangled name. Prints one JSON object
per kernel and, with ``--against``, whether the two trees give the same
numbers for every kernel both have; ``--rename`` rewrites the other tree's
names first (a regular expression), for a kernel whose template arguments
changed. Needs nvcc, so it runs where the card is.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

from repro_torch.kernels.build import CSRC, NVCC_FLAGS, _nvcc


def _demangle(nvcc: str, names: list[str]) -> dict[str, str]:
    """Mangled -> demangled name without its parameter list."""
    res = subprocess.run([str(Path(nvcc).parent / "cu++filt")], input="\n".join(names),
                         capture_output=True, text=True, check=True)
    out = {}
    for name, full in zip(names, res.stdout.splitlines()):
        cut = full.rfind("(")
        out[name] = full[:cut] if cut > 0 and full.endswith(")") else full
    return out


def report(source: Path) -> dict[str, dict]:
    """Kernel (demangled name) -> registers, spill bytes and SASS count."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        cubin = Path(tmp) / "k.cubin"
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-cubin", "-o", str(cubin), str(source)],
                             capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc failed on {source}:\n{res.stdout}{res.stderr}")
        sass = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass", str(cubin)],
                              capture_output=True, text=True, check=True).stdout
    out: dict[str, dict] = {}
    name = None
    for line in (res.stdout + res.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name]["spill_stores"], out[name]["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    name = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})["sass_instructions"] = 0
        elif name and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            out[name]["sass_instructions"] += 1
    names = _demangle(nvcc, list(out))
    return {names[k]: v for k, v in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("source", help="file name under csrc/, e.g. knn.cu")
    ap.add_argument("--against", type=Path, help="another tree's csrc directory")
    ap.add_argument("--rename", nargs=2, metavar=("PATTERN", "REPLACEMENT"),
                    help="rewrite the other tree's kernel names before matching")
    args = ap.parse_args(argv)
    mine = report(CSRC / args.source)
    other = report(args.against / args.source) if args.against else {}
    if args.rename:
        other = {re.sub(*args.rename, k): v for k, v in other.items()}
    same = True
    for name in sorted(set(mine) | set(other)):
        row = {"kernel": name, "this": mine.get(name)}
        if args.against:
            row["other"] = other.get(name)
            if name in mine and name in other:
                row["same"] = mine[name] == other[name]
                same &= row["same"]
        print(json.dumps(row), flush=True)
    if args.against:
        print(json.dumps({"source": args.source, "all_shared_kernels_same": same}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
