"""The port's chained row-fetch probe (``run_walks`` on CPU tensors, i.e.
its plain PyTorch version) against the TPU tool's own Pallas kernel.

``tools/exp_pallas_hbm.py::_walk_kernel`` is loaded by path in a
subprocess (importing the tool points JAX at a persistent compilation
cache and puts a hard-coded path at the head of ``sys.path``) and wrapped in a ``pl.pallas_call`` with ``run_walks``'s specs in
interpret mode.  Tables of 64 to 1024 rows, 10 to 50 steps, k in
{1, 4, 8}: the int32 sums must be equal."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vortex_rt_tpu_torch.runtime import kernels
from vortex_rt_tpu_torch.tools import exp_hbm_walk as hw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = [(64, 10, 4), (64, 10, 1), (257, 50, 8), (1024, 50, 1),
         (1024, 25, 4), (1024, 50, 8)]

# Runs in a fresh interpreter: loads the tool by path, runs its kernel
# through the Pallas interpreter on tables made like make_table's, and
# prints {case: [sum, word-0 checksum]} as JSON.
_JAX_REFERENCE = r"""
import importlib.util, json, os, sys
from functools import partial
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

# the tool's one package import, and its cache setting, are bound here
# first: the package from this checkout (cwd leads sys.path), no cache
from vortex_rt_tpu.utils import cache
cache.enable_persistent_cache = lambda *a, **kw: None
path = list(sys.path)
spec = importlib.util.spec_from_file_location("exp_pallas_hbm",
                                              "tools/exp_pallas_hbm.py")
tool = importlib.util.module_from_spec(spec)
spec.loader.exec_module(tool)
sys.path[:] = path  # drop the tool's hard-coded entry
import vortex_rt_tpu
assert os.path.abspath(vortex_rt_tpu.__file__).startswith(
    os.path.join(os.getcwd(), "")), vortex_rt_tpu.__file__

def run(tab, steps, k):  # run_walks (tools/exp_pallas_hbm.py:85-98)
    n = tab.shape[0]
    kern = partial(tool._walk_kernel, steps=steps, k=k, n=n)
    return pl.pallas_call(
        kern,
        in_specs=[pl.BlockSpec(memory_space=pltpu.ANY)],
        out_specs=pl.BlockSpec(memory_space=pltpu.SMEM),
        out_shape=jax.ShapeDtypeStruct((1,), jnp.int32),
        scratch_shapes=[pltpu.VMEM((k, 1, tool.W), jnp.int32),
                        pltpu.SemaphoreType.DMA((k,))],
        interpret=True,
    )(tab)

out = {}
for rows, steps, k in json.loads(sys.argv[1]):
    tab = np.zeros((rows, tool.W), np.int32)
    tab[:, 0] = np.random.default_rng(0).permutation(rows).astype(np.int32)
    total = int(np.asarray(run(jnp.asarray(tab), steps, k))[0])
    out[f"{rows},{steps},{k}"] = [total, int(tab[:, 0].astype(np.int64)
                                             @ np.arange(rows))]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_sums():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_REFERENCE, json.dumps(CASES)], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("rows,steps,k", CASES)
def test_plain_version_matches_pallas_kernel(jax_sums, rows, steps, k):
    want, word0 = jax_sums[f"{rows},{steps},{k}"]
    tab = hw.make_table(rows, "cpu")
    # the same table as the reference's (word-0 checksum)
    assert int(tab[:, 0].to(torch.int64) @ torch.arange(rows)) == word0
    launches = dict(kernels.LAUNCHES)
    got = hw.run_walks(tab, steps, k)
    assert kernels.LAUNCHES == launches  # CPU tensors never launch
    assert got.dtype == torch.int32 and got.shape == (1,)
    assert int(got[0]) == want


def test_plain_version_is_a_chained_walk():
    """The sum of k independent NumPy walks."""
    rows, steps, k = 96, 7, 8
    tab = hw.make_table(rows, "cpu", seed=3)
    nxt = tab[:, 0].numpy()
    idx = np.arange(k) * (rows // k)
    for _ in range(steps):
        idx = nxt[idx]
    assert int(hw.run_walks_ref(tab, steps, k)[0]) == int(idx.sum())


def test_fetch_width_keeps_the_sum():
    """Fetching 16 B, 96 B or the whole 512-B row per step walks the same
    chain: only word 0 picks the next row."""
    tab = hw.make_table(300, "cpu", seed=5)
    sums = {int(hw.run_walks(tab, 40, 8, words)[0]) for words in (4, 24, 128)}
    assert sums == {int(hw.run_walks_ref(tab, 40, 8)[0])}


@pytest.mark.parametrize("bad", ["k", "dtype", "rows", "words", "row_words"])
def test_run_walks_rejects_bad_inputs(bad):
    tab = hw.make_table(64, "cpu")
    k, words = 4, hw.W
    if bad == "k":
        k = 3
    elif bad == "dtype":
        tab = tab.to(torch.int64)
    elif bad == "rows":
        tab = tab[:2]
    elif bad == "words":
        words = 6
    else:
        tab = tab[:, :6].contiguous()
        words = 4
    with pytest.raises(ValueError):
        hw.run_walks(tab, 10, k, words)


def test_cli_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        hw.main(["--rows", "64", "--steps", "4", "--ks", "1"])
