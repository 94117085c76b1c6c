"""K1 (the 8-wide fused walk) on the card: device time per wave beside
its bound, another version of the kernel in turns, and frame readings.

    python -m vortex_rt_tpu_torch.tools.k1_timing \\
        [--old build/k1_prev/traverse_packet.cu] [--reps 20] \\
        [--frames] [--out build/k1_timing.json]

Waves: the scale scene's four waves of one sample pass at 1920x1080
(``blob(n=187)``, spp 2, depth 2, shadow rays: primary, shadow 0, bounce
1, shadow 1), captured from a real frame, and config 2's 512x512 primary
wave.  For each wave:

- per-ray steps: the mean over walking rays, the mean of the warp
  maximum over 32 consecutive rays (a warp's batch), and the SIMT
  efficiency (steps over 32 x warp maximum, summed over warps);
- the bound (``tools/walk_bounds.py``) from the plain version's work on
  these rays; the kernel's hits and steps must equal the plain version's;
- device time per launch: CUDA events around ``--reps`` launches of the
  bare kernel call (``kernel_call``) after a warm-up, for both versions
  in turns, forwards then backwards (old, new, new, old).  ``--old`` is
  another source of ``traverse_packet.cu`` with the same C interface:
  commit 30f9762's (one thread per ray with a local-memory stack), or a
  copy of the current one with one design piece changed.

It also prints each version's ptxas line and, from ``cuobjdump -sass``,
opcode counts over the kernel, its internal-step loop, its leaf-step loop
and its triangle-slot loop, and per wave an estimate of the time the
new kernel's instruction issue alone takes (``issue_ms``).  With
``--frames``, from the same process: the scale frame (ms/frame, Mrays/s)
and config 2's 3 x 16-frame bursts (Mrays/s), each through the new and
the old kernel in turns, and ``tools/profile_frames.py``'s K1 share at
both scenes through the new one.  Prints one JSON line last and writes it
to ``--out``.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import torch

from vortex_rt_tpu_torch.ops import traverse_packet as tp
from vortex_rt_tpu_torch.ops.traverse2 import Hits
from vortex_rt_tpu_torch.runtime import kernels
from vortex_rt_tpu_torch.tools import walk_bounds as wb
from vortex_rt_tpu_torch.utils.config import LARGE_FLOAT

SCALE_WAVES = ("primary", "shadow0", "bounce1", "shadow1")
SASS_OPS = ("I2F", "I2FP", "PRMT", "FADD", "FMUL", "FMNMX", "FSETP", "LDS", "STS",
            "LDL", "STL")


# ----------------------------------------------------------------- kernels

_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                        r"([A-Z][A-Z0-9_]*)([^;]*);")


def sass_counts(so: Path, dump: Optional[Path] = None) -> Dict:
    """Opcode counts of the walk kernel in a built library's SASS (the
    whole listing written to ``dump`` when given): over the kernel, and
    over its internal step, the loop (a backward branch's span) that holds
    the most FMNMX, i.e. the slab tests.  The loop's count is what a warp
    issues for one internal step with every child slot tested."""
    tool = Path(kernels.nvcc_path()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {out.stderr}")
    text = out.stdout
    if dump is not None:
        dump.parent.mkdir(parents=True, exist_ok=True)
        dump.write_text(text)
    start = text.find("traverse_packet_kernel")
    body = text[start:] if start >= 0 else text
    ins = [(int(at, 16), op, rest) for at, op, rest in _SASS_LINE.findall(body)]

    def count(ops: List[str]) -> Dict[str, int]:
        c = {op: ops.count(op) for op in SASS_OPS}
        c["total"] = len(ops)
        return c

    loops = []
    for at, op, rest in ins:
        target = re.search(r"0x([0-9a-f]+)", rest)
        if op == "BRA" and target and int(target.group(1), 16) < at:
            lo = int(target.group(1), 16)
            loops.append([o for x, o, _ in ins if lo <= x <= at])
    step = max(loops, key=lambda ops: (ops.count("FMNMX"), -len(ops)),
               default=[])
    # the triangle-slot loop (the reciprocal's MUFU) and the leaf step
    # around it
    leaf = sorted((ops for ops in loops if "MUFU" in ops and ops != step),
                  key=len)
    return dict(kernel=count([op for _, op, _ in ins]),
                internal_step=count(step),
                tri_slot=count(leaf[0] if leaf else []),
                leaf_step=count(leaf[1] if len(leaf) > 1 else []))


def issue_ms(wave: Dict, sass: Dict, sms: int, mhz: float) -> float:
    """The least time the kernel could take if its SMs issued one warp
    instruction per scheduler (4 per SM) every cycle at ``mhz``: the
    wave's internal steps, leaf steps and triangle slots (plain version's
    count) times the SASS count of each loop, over 32 lanes and the
    wave's SIMT efficiency.  An estimate: branches taken around parts of
    a loop, and lanes idle for other reasons, are not counted."""
    if not wave["simt_efficiency"]:
        return 0.0
    tri = sass["tri_slot"]["total"]
    lanes = (wave["internal_steps"] * sass["internal_step"]["total"]
             + wave["leaf_steps"] * (sass["leaf_step"]["total"] - tri)
             + wave["tri_slots"] * tri)
    warps = lanes / 32 / wave["simt_efficiency"]
    return warps / (sms * 4 * mhz * 1e6) * 1e3


def other_call(lib: kernels.KernelLibrary, wa, o, d, active=None,
               t_max=None, occlusion: bool = False, occl_split: int = 0,
               max_steps: int = tp.MAX_STEPS) -> Callable:
    """``tp.kernel_call`` through ``lib``, another build of K1 with the
    same C interface: inputs checked and outputs allocated once, each
    call of the returned function one launch into them."""
    tp.kernel_call(wa, o, d, active, t_max, occlusion, occl_split,
                   max_steps)  # the wrapper's checks
    r, dev = o.shape[0], o.device
    limit = (torch.full((r,), LARGE_FLOAT, device=dev) if t_max is None
             else t_max.contiguous())
    on = (torch.ones(r, dtype=torch.bool, device=dev) if active is None
          else active.contiguous())
    out = [torch.empty(r, dtype=torch.float32, device=dev) for _ in range(4)]
    out += [torch.empty(r, dtype=torch.int32, device=dev) for _ in range(3)]
    ptrs = [x.data_ptr() for x in (wa.fused, o.contiguous(), d.contiguous(),
                                   limit, on, *out)]
    ints = (r, wa.fused.shape[0], wa.fused.shape[1],
            max(int(wa.max_leaf_tris), 1), int(wa.tri_bits),
            tp.stack_entries(wa), int(max_steps),
            r if occlusion else int(occl_split))

    def launch():
        err = lib.lib.vrt_traverse_packet(
            *ptrs, *ints, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{lib.name} launch failed: "
                               f"{lib.error_string(err)} ({err})")
        return Hits(*out[:6]), out[6]

    return launch


def ptxas_line(log: str) -> str:
    return " | ".join(ln.strip() for ln in log.splitlines()
                      if "registers" in ln or "stack frame" in ln
                      or "spill" in ln)


# ----------------------------------------------------------------- waves

def capture_waves(scene, n: int, device):
    """The first ``n`` walk calls of a real frame of ``scene``
    (``tools/profile_frames.build``): (renderer, camera, params, w, h,
    [(o, d, kwargs)])."""
    from vortex_rt_tpu_torch.tools.profile_frames import build

    r, cam, p, w, h = build(scene, device)
    waves = []

    def walk(wa, o, d, **kw):
        if len(waves) < n:
            waves.append((o.clone(), d.clone(),
                          {k: (v.clone() if torch.is_tensor(v) else v)
                           for k, v in kw.items()}))
        return tp.trace_packets(wa, o, d, **kw)

    dataclasses.replace(r, walk=walk).render_burst(cam, p, w, h, n_frames=1,
                                                   rays_only=True)
    torch.cuda.synchronize(device)
    return r, cam, p, w, h, waves


def steps_stats(steps: torch.Tensor) -> Dict[str, float]:
    s = steps.to(torch.int64)
    pad = (-s.numel()) % 32
    warps = torch.cat([s, s.new_zeros(pad)]).view(-1, 32)
    wmax = warps.max(1).values
    walking = s > 0
    return dict(
        mean_steps=float(s[walking].float().mean()) if walking.any() else 0.0,
        warp_max_steps=float(wmax[wmax > 0].float().mean())
        if (wmax > 0).any() else 0.0,
        simt_efficiency=float(s.sum()) / max(float(32 * wmax.sum()), 1.0),
        walking_rays=int(walking.sum()))


def device_ms(fn: Callable, reps: int, warmup: int = 3) -> float:
    """Mean device time per call of ``fn`` from CUDA events around
    ``reps`` calls, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def same(a, sa, b, sb) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b)) and torch.equal(sa, sb)


def time_wave(wa, o, d, kw, versions: Dict[str, Callable], reps: int
              ) -> Dict:
    """Check every version against the plain walk, then time them in
    turns, forwards then backwards."""
    ref, ref_steps, work = tp.walk_work(wa, o, d, **kw)
    bound = wb.k1_bound(work, width=wa.width)
    calls = {}
    for name, make in versions.items():
        calls[name] = make(wa, o, d, **kw)
        hits, steps = calls[name]()
        torch.cuda.synchronize()
        if not same(hits, steps, ref, ref_steps):
            raise RuntimeError(f"{name}: hits or steps differ from the "
                               f"plain version")
    order = list(calls) + list(reversed(list(calls)))
    times: Dict[str, List[float]] = {name: [] for name in calls}
    for name in order:
        times[name].append(device_ms(calls[name], reps))
    out = dict(rays=o.shape[0], **steps_stats(ref_steps),
               internal_steps=int(work.internal.sum()),
               leaf_steps=int(work.leaf.sum()),
               child_slots=int(work.child_slots.sum()),
               tri_slots=int(work.tri_slots.sum()),
               bound_ms=bound.ms, bound_by=bound.bound_by,
               ops_ms=bound.ops_ms, bytes_ms=bound.bytes_ms, versions={})
    for name, ts in times.items():
        ms = sum(ts) / len(ts)
        out["versions"][name] = dict(ms=ms, turns=ts,
                                     bound_share=bound.ms / ms)
    return out


# ulps of a hit's dist within which two trees' walks may pick different
# triangles (ROADMAP hazards H3, H24)
TIE_ULPS = 4


def tie_split(a: Hits, b: Hits) -> Dict[str, int]:
    """Rays whose hits differ between two walks of one scene's two trees,
    split by cause: ``ties`` where both found a hit and their ``dist``
    are within ``TIE_ULPS`` float32 ulps (an exact-t tie resolved by visit
    order, H3, or a near tie on an edge two leaves share, where one
    tree's leaf box enters at the other triangle's t after rounding and
    is pruned, H24), else ``other`` (a fault)."""
    diff = torch.zeros_like(a.dist, dtype=torch.bool)
    for x, y in zip(a, b):
        diff |= x != y
    ulp = torch.nextafter(a.dist, torch.full_like(a.dist, float("inf"))) \
        - a.dist
    tie = (diff & (a.dist < LARGE_FLOAT) & (b.dist < LARGE_FLOAT)
           & ((a.dist - b.dist).abs() <= TIE_ULPS * ulp))
    return dict(differ=int(diff.sum()), ties=int(tie.sum()),
                other=int((diff & ~tie).sum()))


def width_pair_wave(wa16, wa8, o, d, kw, reps: int,
                    extra: Optional[Dict] = None,
                    bound_kw: Optional[Dict] = None) -> Dict:
    """One wave walked by K1 over a 16-wide and an 8-wide table of one
    scene, on the same rays.  Each width's kernel against its plain walk
    (hits and per-ray steps equal, else raises), and its counting
    instantiation's internal steps against the plain walk's count; the
    16-wide hits against the 8-wide ones (``tie_split``: a ray that
    differs must be an exact-t tie); device ms of both by CUDA events
    around the bare launch, in turns (16, 8, 8, 16); per width the mean
    steps, internal and leaf steps a walking ray, and the bound
    (``walk_bounds.k1_bound`` at that width, with ``bound_kw``) and its
    share.  ``extra`` ({name: (launcher, exact)}: other versions of the
    16-wide walk on these rays) joins the turns after width 8; an
    ``exact`` one must give the 16-wide kernel's hits and steps (else
    raises), the others (timing copies) report their mean steps."""
    out: Dict = dict(rays=int(o.shape[0]),
                     live=int(kw["active"].sum()) if "active" in kw
                     else int(o.shape[0]))
    extra = extra or {}
    calls, hits = {}, {}
    for name, wa in (("w16", wa16), ("w8", wa8)):
        ref, ref_steps, work = tp.walk_work(wa, o, d, **kw)
        calls[name] = tp.kernel_call(wa, o, d, **kw)
        h, s = calls[name]()
        hs, ss, kinds = tp.kernel_call(wa, o, d, stats=True, **kw)()
        torch.cuda.synchronize()
        if not (same(h, s, ref, ref_steps) and same(hs, ss, ref, ref_steps)):
            raise RuntimeError(f"K1 at width {wa.width}: hits or steps "
                               f"differ from the plain walk")
        if not torch.equal(kinds.internal, work.internal.to(torch.int32)):
            raise RuntimeError(f"K1's counting instantiation at width "
                               f"{wa.width}: internal steps differ")
        hits[name] = Hits(*(x.clone() for x in h))
        if name == "w16":
            steps16 = s.clone()
        walking = max(int(((work.internal + work.leaf) > 0).sum()), 1)
        b = wb.k1_bound(work, width=wa.width, **(bound_kw or {}))
        out[name] = dict(**steps_stats(ref_steps),
                         internal_per_ray=int(work.internal.sum()) / walking,
                         leaf_per_ray=int(work.leaf.sum()) / walking,
                         internal_steps=int(work.internal.sum()),
                         leaf_steps=int(work.leaf.sum()),
                         child_slots=int(work.child_slots.sum()),
                         bound_ms=b.ms, bound_by=b.bound_by, turns=[])
    out["hits_vs_8wide"] = tie_split(hits["w16"], hits["w8"])
    if out["hits_vs_8wide"]["other"]:
        raise RuntimeError(f"K1 at width 16 finds other hits than at width "
                           f"8: {out['hits_vs_8wide']}")
    for name, (call, exact) in extra.items():
        h, s = call()
        torch.cuda.synchronize()
        calls[name] = call
        out[name] = dict(equal=same(h, s, hits["w16"], steps16),
                         mean_steps=steps_stats(s)["mean_steps"], turns=[])
        if exact and not out[name]["equal"]:
            raise RuntimeError(f"{name}: hits or steps differ from the "
                               f"16-wide kernel's")
    order = ["w16", "w8", *extra]
    for name in order + order[::-1]:
        out[name]["turns"].append(device_ms(calls[name], reps))
    for name in order:
        rec = out[name]
        rec["ms"] = sum(rec["turns"]) / len(rec["turns"])
        if name in ("w16", "w8"):
            rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        else:
            rec["vs_w16"] = rec["ms"] / out["w16"]["ms"]
    return out


# ----------------------------------------------------------------- frames

def frame_readings(scenes: Dict, walks: Dict[str, Callable]) -> Dict:
    """The scale frame (ms, Mrays/s, one frame after a warm-up) and config
    2's 3 x 16-frame bursts through each walk, in turns forwards then
    backwards; then profile_frames' K1 share at both scenes through the
    current kernel."""
    from vortex_rt_tpu_torch.tools import profile_frames as pf

    order = list(walks) + list(reversed(list(walks)))
    out: Dict[str, Dict] = {name: dict(scale_ms=[], scale_mrays=[],
                                       config2_mrays=[]) for name in walks}
    for name in order:
        r, cam, p, w, h, _ = scenes["scale"]
        rs = dataclasses.replace(r, walk=walks[name])
        rs.render_burst(cam, p, w, h, n_frames=1, seed0=0, rays_only=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rays = rs.render_burst(cam, p, w, h, n_frames=1, seed0=1,
                               rays_only=True)
        dt = time.perf_counter() - t0
        out[name]["scale_ms"].append(dt * 1e3)
        out[name]["scale_mrays"].append(rays / dt / 1e6)
        r, cam, p, w, h, _ = scenes["config2"]
        rc = dataclasses.replace(r, walk=walks[name])
        rc.render_burst(cam, p, w, h, n_frames=16, seed0=0, rays_only=True)
        torch.cuda.synchronize()
        total, t0 = 0, time.perf_counter()
        for i in range(3):
            total += rc.render_burst(cam, p, w, h, n_frames=16,
                                     seed0=(i + 1) * 16, rays_only=True)
        out[name]["config2_mrays"].append(
            total / (time.perf_counter() - t0) / 1e6)
    prof = {}
    for label, frames in (("config2", 8), ("scale", 3)):
        r, cam, p, w, h, _ = scenes[label]
        res = pf.profile(r, cam, p, w, h, frames)
        k1 = [t for t in res["top"] if "traverse_packet" in t["name"]]
        prof[label] = dict(
            frame_ms=res["frame_ms"], busy_share=res["busy_share"],
            device_ms_per_frame=res["device_ms_per_frame"],
            launches_per_frame=res["launches_per_frame"],
            k1_share=k1[0]["share"] if k1 else None,
            k1_ms_per_frame=k1[0]["ms_per_frame"] if k1 else None,
            k1_launches_per_frame=k1[0]["launches_per_frame"] if k1 else None)
    return dict(turns=out, profile=prof)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", default=None,
                    help="another traverse_packet.cu with the same C "
                    "interface (e.g. commit 30f9762's)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--frames", action="store_true",
                    help="also the frame-level readings")
    ap.add_argument("--out", default=None, help="write the JSON here too")
    ap.add_argument("--sass-dir", default=None,
                    help="write each version's SASS listing here")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1_timing: no CUDA device")
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(device)}; {smi}", flush=True)
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(device).multi_processor_count

    libs = {"new": kernels.load("traverse_packet")}
    versions: Dict[str, Callable] = {}
    walks: Dict[str, Callable] = {"new": tp.trace_packets}
    if a.old:
        old = kernels.load_file("traverse_packet", Path(a.old))
        libs["old"] = old
        versions["old"] = lambda *x, **kw: other_call(old, *x, **kw)
        walks["old"] = lambda *x, **kw: other_call(old, *x, **kw)()
    versions["new"] = tp.kernel_call
    build = {}
    for name, lib in libs.items():
        dump = Path(a.sass_dir) / f"{name}.sass" if a.sass_dir else None
        build[name] = dict(ptxas=ptxas_line(lib.build_log),
                           sass=sass_counts(lib.path, dump))
        print(f"{name}: {build[name]['ptxas']}\n  sass {build[name]['sass']}",
              flush=True)

    scenes = {"scale": capture_waves("scale", len(SCALE_WAVES), device),
              "config2": capture_waves("config2", 1, device)}
    wa = scenes["scale"][0].wa
    res = dict(device=torch.cuda.get_device_name(device), smi=smi,
               sm_count=sms, max_sm_mhz=mhz, build=build,
               scale_depth=int(wa.depth), waves={})
    for scene, names in (("scale", SCALE_WAVES), ("config2", ("primary",))):
        r, waves = scenes[scene][0], scenes[scene][5]
        for name, (o, d, kw) in zip(names, waves):
            out = time_wave(r.wa, o, d, kw, versions, a.reps)
            out["issue_ms"] = issue_ms(out, build["new"]["sass"], sms, mhz)
            out["issue_share"] = out["issue_ms"] / out["versions"]["new"]["ms"]
            res["waves"][f"{scene}/{name}"] = out
            print(f"{scene}/{name}: rays {out['rays']} mean steps "
                  f"{out['mean_steps']:.3f} warp-max {out['warp_max_steps']:.3f}"
                  f" simt {out['simt_efficiency']:.3f} bound "
                  f"{out['bound_ms']:.4f} ms ({out['bound_by']}) "
                  + " ".join(f"{k} {v['ms']:.4f} ms ({v['bound_share']:.1%})"
                             for k, v in out["versions"].items())
                  + f"; issue estimate {out['issue_ms']:.4f} ms "
                  f"({out['issue_share']:.1%} of new)",
                  flush=True)
    if a.frames:
        res["frames"] = frame_readings(scenes, walks)
        print(f"frames: {json.dumps(res['frames'])}", flush=True)
    line = json.dumps(res)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(line + "\n")
    print(line)
    return res


if __name__ == "__main__":
    main()
