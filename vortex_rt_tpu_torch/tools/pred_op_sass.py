"""The instruction counts of the predicate compiler's correctly rounded
ops on the card: the weights ``tools/walk_bounds.pred_ops`` gives them.

Builds one kernel per correctly rounded op (``ops/anyhit_pred.py``), each
``out[i] = <the op's emitted expression>(x[i][, y[i]])`` exactly as the
compiler emits it into ``vrt_pred``, and a baseline kernel ``out[i] =
x[i]``, with the kernels' nvcc flags (``runtime/kernels.NVCC_FLAGS``:
``-fmad=false``, no fast math), and reads their SASS with ``cuobjdump
-sass``.  Per op:

- ``main``: the instructions from the kernel's entry to its first
  unpredicated ``EXIT``, and the body (to its ``RET``) of every
  subroutine called there by an unpredicated ``CALL`` that no earlier
  branch jumps over (``pow``'s core is such a call), less the
  baseline's: the sequence one evaluation issues on its common path (a
  slow path, such as the Payne-Hanek reduction of a large ``sin``
  argument or a double division's special cases, is laid out after that
  ``EXIT`` or called conditionally, and is not counted; a binary op's
  count includes its second operand's load);
- ``dp``: the FP64 arithmetic instructions (``DADD``, ``DMUL``,
  ``DFMA``) among them, which issue at half the FP32 rate on an H100;
- ``weight`` = ``main`` + ``dp``: the op's count in FP32-operation
  equivalents, the unit of ``walk_bounds``'s operations;
- ``total`` and ``calls``: every instruction of the kernel, slow paths
  included, and its ``CALL`` instructions.

Prints one JSON line (with the card's name and power limit and nvcc's
version); ``--out`` writes it there too.  Needs ``nvcc`` and
``cuobjdump`` (the CUDA toolkit), not a card to run on:

    python -m vortex_rt_tpu_torch.tools.pred_op_sass --out chiprun_out/pred_op_sass.json
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
from pathlib import Path

from vortex_rt_tpu_torch.ops import anyhit_pred
from vortex_rt_tpu_torch.runtime import kernels

_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                        r"([A-Z][A-Z0-9_]*)([^;]*);")
_TARGET = re.compile(r"0x([0-9a-f]+)")
DP_OPS = ("DADD", "DMUL", "DFMA")


def source() -> str:
    """One kernel per correctly rounded op and the baseline."""
    out = ['extern "C" __global__ void k_base(const float* x, const float* '
           'y, float* out, int n) {\n    const int i = blockIdx.x * '
           'blockDim.x + threadIdx.x;\n    if (i < n) out[i] = x[i];\n}\n']
    for kind, (_, arity) in anyhit_pred._CORRECTLY_ROUNDED.items():
        expr = anyhit_pred._correctly_rounded(kind, ["x[i]", "y[i]"][:arity])
        out.append(f'extern "C" __global__ void k_{kind}(const float* x, '
                   f'const float* y, float* out, int n) {{\n    const int '
                   f'i = blockIdx.x * blockDim.x + threadIdx.x;\n    if (i '
                   f'< n) out[i] = {expr};\n}}\n')
    return "".join(out)


def counts(sass: str) -> dict:
    """{kernel: dict(main, dp, total, calls)} from ``cuobjdump -sass``."""
    def target(rest: str) -> int:
        m = _TARGET.search(rest)
        return int(m.group(1), 16) if m else -1

    found = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name = part.split()[0]
        ins = [(int(at, 16), bool(pred), op, rest)
               for at, pred, op, rest in _SASS_LINE.findall(part)
               if op != "NOP"]
        end = next((j for j, (_, p, op, _) in enumerate(ins)
                    if op == "EXIT" and not p), len(ins) - 1)
        path = ins[:end + 1]
        jumps = [(at, target(rest)) for at, _, op, rest in path
                 if op == "BRA"]
        for at, p, op, rest in ins[:end + 1]:
            if op != "CALL" or p or any(a < at < t for a, t in jumps):
                continue
            body = [x for x in ins if x[0] >= target(rest)]
            ret = next((j for j, x in enumerate(body) if x[2] == "RET"),
                       len(body) - 1)
            path += body[:ret + 1]
        found[name] = dict(main=len(path),
                           dp=sum(op in DP_OPS for _, _, op, _ in path),
                           total=len(ins),
                           calls=sum(op == "CALL" for _, _, op, _ in ins))
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--sass", default=None,
                    help="write cuobjdump's listing here too")
    args = ap.parse_args(argv)
    d = kernels.BUILD_DIR / "pred_op_sass"
    d.mkdir(parents=True, exist_ok=True)
    cu = d / "pred_ops.cu"
    cu.write_text(source())
    so, _, _ = kernels._build(cu)
    tool = Path(kernels.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    for path in (d / "pred_ops.sass", args.sass):
        if path:
            Path(path).parent.mkdir(parents=True, exist_ok=True)
            Path(path).write_text(sass)
    by = counts(sass)
    base = by.pop("k_base")
    ops = {}
    for name, c in sorted(by.items()):
        main_n = c["main"] - base["main"]
        ops[name[2:]] = dict(c, main=main_n, weight=main_n + c["dp"])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    nvcc = subprocess.run([kernels.nvcc_path(), "--version"],
                          capture_output=True, text=True).stdout.strip()
    line = json.dumps(dict(card=card or "no card", nvcc=nvcc.splitlines()[-1],
                           baseline=base, ops=ops))
    for k, c in ops.items():
        print(f"  {k}: weight {c['weight']} (main {c['main']}, dp "
              f"{c['dp']}; total {c['total']}, calls {c['calls']})")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
