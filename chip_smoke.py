#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vortex_rt_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's thirteen CUDA kernel libraries from the sources in this
checkout (one nvcc per source, all started together), holds each kernel
against its plain PyTorch version on the card (hits and per-ray steps
identical; every word of the LBVH and PLOC builds' and refits' outputs
equal),
drives the port's entry points through them, and measures them: kernel
times are device times from CUDA events, beside each kernel's bound
(``vortex_rt_tpu_torch/tools/walk_bounds.py``).  Phases (each raises,
and so exits non-zero, on failure):

1. device: a CUDA device is required; prints the card's name and power
   limit as nvidia-smi reports them;
2. build: ``csrc/packet_walk.cu`` (K2), ``csrc/traverse_packet.cu`` (K1;
   both include ``csrc/alpha_test.cuh``), ``csrc/traverse_wide.cu`` (K3),
   ``csrc/hbm_walk.cu`` (K7), the four of the on-device LBVH build and
   refit (K5: ``csrc/lbvh_karras.cu``, ``lbvh_collapse.cu``,
   ``lbvh_refit.cu``, ``lbvh_pack.cu``), the three of the PLOC build
   and level refit (K4: ``csrc/ploc_merge.cu``, ``ploc_collapse.cu``,
   ``ploc_refit.cu``; its leaf rows are ``lbvh_pack.cu``'s leaf kernel
   reading explicit triangle ids), the megakernel's binary walk (K6,
   ``csrc/traverse2.cu``) and the sweep-SAH tree (``csrc/lbvh_sah.cu``),
   with their build times;
3. K2 against its plain version: config-2 camera rays at 64x64 on the
   flat 4-wide build and on a TLAS build (two instances), in four modes
   (closest, 1/3 inactive, half t_max-clamped, shadow-ray occlusion);
4. one config-2 frame at 64x64 through K2 and through the plain version
   (4-wide route): equal ray counts, images within 1e-5;
5. K1 against its plain version: config-2 camera rays at 64x64 on the
   8-wide fused build, in five modes (the four above and a mixed
   ``occl_split`` wave of shadow and camera rays);
6. a 64x64 spp-2 frame at depth 3 (reflective sphere) through K1 and
   through the plain version: equal ray counts, images within 1e-5, K1
   launched 5 times per sample pass, one of them the mixed wave;
7. config 2 as ``bench.py`` renders it (``models/config2.py``, where the
   bench entry and the ladder take it from; 8-wide fused, 512x512, spp
   2, depth 2, shadow rays): the main path's run (launch counts reset
   before it), checked against the plain version; then ladder row 2 on
   the same renderer (``bench_ladder.run_row``, launch counts reset
   before it: 3 x 16-frame bursts timed after a warm-up, Mrays/s as
   bench.py defines it, K1 8 times a frame and nothing else, the golden
   parity at 16 pixels); the bench entry (``tools/bench.py``) on the same
   renderer (one build serving both; launch counts reset before it), its
   JSON line parsed (``vs_baseline`` = value / 200, the card's line in
   ``gpu``), K1 launched 8 times a frame; one primary
   wave timed through K1 (bare kernel call, CUDA events) and plain, with
   its bound.  Then one frame at depth 3 with a reflective sphere
   (merged wave with live bounce lanes) against the plain route;
8. config 2 at 512x512 through the 4-wide route (K2's path, launch counts
   reset before it), against the plain route; one primary wave timed
   through K2 (the bare kernel call, CUDA events) and plain, with its
   bound;
8b. the native host builder: compiles ``csrc/builder.cpp``, builds the
   blob and the atrium with it, prints build seconds beside the NumPy
   build's for the blob, and checks the native-built blob against the
   NumPy-built one by K1's hits on a crop of camera rays (same hit mask,
   same ``tri``, ``dist`` within 2e-4 relative).  The phases below use
   the native builds;
9. the scale scene, ``blob(n=187)`` at 1920x1080, spp 2, depth 2, shadow
   rays, Whitted, 8-wide: one frame timed after a warm-up, table bytes, peak
   memory; then the frame's four waves of one sample pass (primary,
   shadow 0, bounce 1, shadow 1) captured, K1 checked against the plain
   version on each and timed per wave (CUDA events), with steps per ray
   (mean, warp maximum) and the bound;
9b. K1 against its plain version on the scale scene's depth-9 tree: a
   crop of ``SCALE_CROP`` camera rays (not a multiple of 32; 4,225
   blocks of 128, over four times what 132 SMs hold at once at 8 blocks
   each) and their shadow rays, in four modes (closest, 1/3 inactive,
   occlusion, mixed);
9c. ladder config 3's render: ``blob(n=187)``, 1920x1080, spp 4, depth 3,
   shadow rays, path traced, 8-wide fused, host-built (phase 11b renders
   it from the tree built on the card): launch counts reset, one frame
   after a warm-up through ``render_burst(n_frames=1)``; finite image,
   rays, ms, Mrays/s, peak bytes, 5 K1 launches per sample pass; then
   the kernel route against the plain route at ``PT_SMALL`` and spp 2
   (equal ray counts, images within 1e-5); then the five waves of its
   first sample pass as in 9e;
9d. ladder config 4: ``atrium()`` (259,594 triangles), 1920x1080, spp 8,
   depth 3, shadow rays, path traced; the same readings and checks;
9e. the five waves of one sample pass of config 4 (closest 0, shadow 0,
   closest 1, merged shadow 1 + closest 2, shadow 2) captured from a
   frame: K1 against the plain version on each (hits and per-ray steps
   exact), its device time (CUDA events around the bare launch), live
   lanes, steps per ray (mean, warp maximum), SIMT efficiency, bound;
9f. ``render_accum(n_passes=2, spp=2)`` of config 4 at ``PT_SMALL``
   against the mean of two ``frame_body(total_spp=4)`` frames (1e-6);
9g. ladder rows 1 and 4 as ``tools/bench_ladder.run_row`` runs them (row
   1: the Cornell box, 256x256, spp 2, depth 1; row 4: config 4 on phase
   9d's renderer, one build serving both; row 2 is phase 7's), launch
   counts reset before each: K1 2 and 40 times a frame and no other
   kernel, the golden parity (``parity_ok``, RMSE below 3e-3 at 16 and 8
   sampled pixels), row 1's frame against the plain route at full size
   (row 4's is 9d's); the bench entry is phase 7's;
10. K7: ``run_walks`` against ``run_walks_ref`` at 29,140 rows (sums
    equal) for 16-, 96- and 512-byte row fetches, then the probe's entry
    point (launch counts reset before it) at 29,140 rows (14.2 MiB,
    L2-resident) and 1,048,576 rows (512 MiB, beyond L2): ns/step and
    ns/step/walk for k in {1, 4, 8, 16, 32} at each fetch width;
11a. K5, each LBVH kernel against its plain version on the card: the
    scene box, Morton codes and the Karras tree (A), the collapse with the
    refit plan in one launch (B; the plan against ``_refit_plan`` and its
    records against ``_refit_records_ref``), the bottom-up boxes over
    that plan (C; its counters zero after its launches), the pack (D), on ``uv_sphere``, ``random_soup(2000)`` and a
    100k-triangle ``wavy_grid(n=225)``, widths 4 and 8, leaf 4 and 8,
    full and compact pools, flat and (4-wide) TLAS layouts: every integer
    field and every output word equal, and a second launch gives the
    same words;
11b. ladder row 3 on a Karras tree built on the card
    (``tools/bench_ladder.config3(method="karras")``): K1 over the 1080p
    camera rays finds
    the same hit mask, triangle ids and distances to the bit as over the
    host-built tree; then the row's frame (spp 4, depth 3, path traced)
    with its ray count beside phase 9c's, and the difference of the same
    frame from both trees; then the four LBVH kernels against their plain
    versions at this path's shapes (the row's mesh, the full pool, fused
    rows), word for word;
11c. ladder row 5 at full width (``tools/bench_ladder.config5``):
    ``wavy_grid(n=708)``, 999,698 triangles, 1920x1080, spp 2, depth 2,
    shadow rays, Whitted, light (0, 14, 0), flat 8-wide, leaf 4; the
    topology built on the card, ``compact_plan``, then refit + repack +
    fused rows and a frame at four moved times after a warm-up, with no
    host build and no copy to the host inside the refit.  The t = 0
    frame equals the frame from the native host-built tree within 1e-5
    with equal ray counts; on a crop of camera rays K1 over the refit
    tree gives the plain walk's hits and steps; build, refit and frame
    times (the build a median of ``bench_ladder.BUILD_REPS``, one launch
    of K5 B and of K5 C's refit a build), pool sizes and peak bytes are
    printed; each LBVH kernel is
    held against its plain version at this path's shapes (999,700
    triangles, the compact plan, fused rows) word for word, and timed
    there (CUDA events around its wrapper; its kernels alone from the
    profiler beside that: the box + codes and Karras kernels apart)
    beside its plain version and its bound; the refit's plan of a
    topology made elsewhere timed; the device operations of K5 A's and K5
    B's wrappers (one each) and of a whole build, none a fill, scan,
    search or scatter outside the sort; those of one refit + repack, none
    a fill or a reduction;
12a. K4, each PLOC kernel against its plain version on the card: the
    merge rounds (K4a), the remap and collapse in one launch (K4b), the
    leaf-row boxes and two refits in a row over moved vertices, each one
    launch into unfilled outputs (K4c), the pack from explicit
    leaf ids (K4d), on phase 11a's three meshes at widths 4 and 8, leaf 4
    and 8, radius 16, and on the grid also at radius 8: every output word
    equal (every ``PLOCTopo`` field, ``n_int`` and ``n_levels``), a
    second launch the same words, the refit at the build's vertices the
    build's tables;
12b. ladder row 3 as the ladder defines it (``tools/bench_ladder.config3``,
    PLOC, radius 16; launch counts reset before and read after): build
    ms, rounds, pool and leaf rows, the tree's real depth, K1 over the
    1080p camera rays with the host-built tree's hits to the bit, the
    row's frame and the seed-0 frame from both trees; then K1 over the
    camera rays on the PLOC, Karras and host SAH trees (hits equal, mean
    and largest steps per ray), and on the five waves of a sample pass
    over the PLOC tree as 9c times them; then the K4 kernels against their plain
    versions at this path's shapes, and timed there (CUDA events around
    each wrapper, plain time, bytes bound);
12c. PLOC at config 5's mesh (phase 11c's 999,700 triangles, 8-wide,
    leaf 4): build ms and rounds, ``refit_ploc`` at t = 0 against the
    build's words, the refit per frame with config 5's ripple, K1 steps
    over the PLOC, Karras and SAH trees on phase 11c's crop and on shadow
    rays towards the light (hits equal), the K4 kernels against their
    plain versions at this size, and timed there;
13c. ladder row 6 (``tools/bench_ladder.setup6/frames6``):
    ``textured_atrium()`` flat 8-wide, ``alpha_test_anyhit(0.30)`` inside
    K1, spp 2, depth 2, shadow rays, 512x512 and 1920x1080 frames (a
    warm-up and two timed each), launch counts reset before: K1's alpha
    mode 8 launches a frame, no K3, no K1 without alpha; ms/frame,
    Mrays/s, peak and table bytes; then a 512x512 frame of the same scene
    on the 4-wide TLAS build through K2's alpha mode (8 launches, equal
    ray count);
13a. K3 against its plain version: the cutout scene (TLAS) at 128x128,
    auto-accept and a suspension loop of mixed CONT / ACCEPT / TERM
    actions, and a 96x96 crop of the textured atrium's TLAS build,
    auto-accept and three rounds of the alpha test's own actions: every
    state field (hits, pending hits, trail, stack, ``nodes_visited``,
    ``tri_tests``) equal, through ``trace_lanes`` (a copy walked) and
    in place on a state of its own (the pool path's rounds); then K3's
    first suspension round of the parity frame's primary wave (73,728
    lanes), in place as the pool path runs it, timed by the profiler's
    kernel time with the state put back before each launch (CUDA events
    around launches on fresh states made beforehand beside it, in its
    place where the profiler records no launch: they read the host's
    pace of a launch) beside its plain version, its bound (what a walking
    lane reads and changes; the first version's every-lane figure beside)
    and its blocks an SM, the relaunched state checked again;
13b. K1's and K2's alpha modes against their plain versions on row 6's
    tables (512x512 camera rays, their shadow rays, and for K1 a mixed
    wave): hits and per-ray steps equal; each primary wave timed in
    alpha mode and without alpha beside its bound; K1's times without
    alpha on config 2's and the scale scene's primary waves re-read;
13d. row 6's gate (``bench_ladder.parity6``): the 192x192 frame in the
    walk against the suspension engine (``RTConfig(packet_size=0)`` on
    the TLAS build, K3 + ``commit``), launch counts reset before: RMSE
    below 1e-4, equal ray counts, K3's launches (its rounds); then
    ``render(mode="chunked")`` at 128x128 on the TLAS build with the
    default shaders, its compacted pool traced by K3, against the same
    frame traced by the plain walk (within 1e-5, equal ray counts);
12d. the sweep-SAH tree (``build_lbvh_topo(method="sah")``) at config
    3's mesh (69,940 triangles, 8-wide, leaf 4; launch counts reset
    before one build: one ``lbvh_sah`` launch): build ms, levels, the
    real wide depth; the tree's kernel against ``_sah_sweep_tree_ref`` on
    the same sorted leaf boxes (the plain version run on the card),
    lchild, rchild, lo, hi and the live positions of each level word for
    word, and K5 C's boxes over the tree and its plan against theirs; one
    launch (the wrapper's count) and one read to the host a sweep
    (PyTorch's warnings on synchronising operations); the sweep timed
    (CUDA events; its kernel by the profiler) beside its bound (a live
    position's box each level; the first version's every-position figure
    beside) and
    the plain version;
    then K1 over config 3's 1080p camera rays on the host SAH, Karras,
    PLOC and sweep-SAH trees: hits equal to the bit, steps per ray;
12e. the same at config 5's mesh (999,700 triangles), K1 on phase 11c's
    crop over the host SAH, Karras and sweep-SAH trees;
15a. MK-A, the megakernel engine (``MegakernelRenderer``, K6 each wave)
    on config 2's scene in the TLAS layout with the sphere at
    reflectivity 0.6, 512x512, spp 4 (threefry jitter), depth 3: launch
    counts reset before three timed frames after a warm-up; ms a frame,
    Mrays/s, rays, peak bytes, 12 K6 launches a frame, the pool's binary
    depth beside K6's 64 stack entries; then a 64x64 spp-2 frame on the
    card against the same frame on the CPU (equal rays, within 1e-5);
15b. MK-B, the megakernel engine on ``atrium()``'s TLAS over 29 BLASes
    (host-built), 1920x1080, spp 1, depth 2 (the CLI's ``-m atrium -w
    1920 -H 1080 --engine megakernel``): the same readings, 2 K6
    launches a frame (the second wave has no live lane, no instance
    reflects);
15c. K6 against its plain version (run on the card) on MK-A's three
    waves (the bounce waves with their live masks), MK-B's primary wave,
    67,601 random rays over transformed instances (all live and a third
    dead, stack depth 64 and 4: the clamped overflow) and 20,000 rays
    through ``chain_pool(100)``, a pool 102 levels deep (stack depth 64
    and 4, walks that defer 100 leaves): hits and per-ray counts equal;
    K6 timed (CUDA events around the launch, the profiler's kernel time
    and the launches it recorded beside) on MK-A's
    primary and first bounce waves and MK-B's primary wave, beside the
    plain version and ``k6_bound``, with the bytes K6's packed records
    make it fetch;
15d. K2 on the atrium's 4-wide TLAS build (MK-B's scene) at 1920x1080,
    2,073,600 camera rays: checked against the plain version on a strided
    crop of 66,891 rays through the wrapper and on the whole wave through
    the bare launch (hits and steps equal), timed (CUDA events around the
    bare launch) beside the plain version on the crop and ``k2_bound`` of
    the whole wave;
17a. ladder config 3 through the CLI and the OBJ loader: ``blob(n=187)``
    written to an OBJ (a v, vn and vt line a corner, %.9g) and read back
    (every array equal; seconds printed), ``cli.main`` at 1920x1080, spp
    4, depth 3, shadow rays, path traced (20 K1 launches), its image
    within 1e-5 of the same frame rendered from the mesh in memory, equal
    rays; the CLI's ms (table build included) and the frame's alone;
17b. the CLI's ``--perf`` at config 2's shape (cornell, 512x512, depth 2,
    shadow rays): 4 launches of K1's counting instantiation; then
    ``perf_trace`` on the renderer the CLI builds and on its 4-wide
    build (K2's counting instantiation), every wave captured: hits,
    steps and per-ray internal and instance steps equal ``walk_work`` /
    ``walk_work_4`` word for word, the counters equal the plain sums and
    maxima, ``perf_trace`` equal to the CLI's printed lines; each wave's
    default and STATS kernels timed in turns (CUDA events; the
    profiler's kernel time on the primary wave); one alpha wave of row 6's scene at 192x192
    through K1's and K2's counting instantiations; ptxas lines of both
    instantiations;
17c. the CLI's ``--scope-out`` at config 2's shape: the JSON parses, its
    spans tile one timeline, their labels equal ``frame_profile``'s;
    per-stage ms;
17d. the CLI's ``--compare`` on cornell at 256x256, depth 2 (PASS), and
    MK-B through the CLI (``-m atrium --engine megakernel``, 2 K6
    launches);
17e. the RT-unit facade (``engine/rtu.py``) on the atrium's 4-wide TLAS
    build: the reference's persistent kernel loop over 512x512 camera
    rays, an any-hit handler rejecting odd triangle ids; closest hits
    equal the pool path's (``walk_lanes`` rounds, same action) to the
    bit; rays/s, rounds, K3 launches; the device API (``dev_open``,
    copy, start, ready_wait, dump_perf) once;
18a. multi-device rendering by row blocks (``parallel/tiles.py``), every
    rank a process on this one card through gloo and a ``file://``
    store (``parallel/launch.spawn``): ladder config 3's render (blob,
    1920x1080, spp 4, depth 3, path traced, 8-wide fused through K1)
    over 2 ranks, ``render_tiled_wavefront`` once with each rank's launch
    counts reset before it and read after (K1 launched on every rank);
    the gathered image equals one device's ``render`` of the frame
    (max diff <= 1e-5) with the same rays; each rank's frame ms (its
    step after a warm-up; ranks sharing one card measure no scaling);
18b. the tiled megakernel (``render_tiled``, K6 every wave) on MK-A's
    scene at 512x512, depth 3, over the same 2 ranks against one
    device's megakernel frame at spp 1 (the tiled step renders pixel
    centres, as the JAX one does);
18c. scene shards (``parallel/shards.py``), ``render_sharded`` with the
    ``replicate`` schedule: the atrium (259,594 triangles, 29 instances,
    4-wide TLAS, K2 on every shard) at 1920x1080, spp 1, depth 2, shadow
    rays, at dp=1 x sp=2 (2 ranks) and dp=2 x sp=2 (4 ranks): RMSE below
    1e-5 against one device's 4-wide frame, equal rays, K2 launched on
    every rank; ``memory_table`` at sp=2 and sp=4;
18d. the ``alltoall`` schedule at dp=1 x sp=2 (in 18c's launch): the
    same gates, its per-ray walk steps below ``replicate``'s, the bytes
    gloo moved through host memory for the CUDA tensors printed (gloo
    runs each collective on them itself: nothing is staged by the port,
    ``tools/gloo_cuda_probe.py``);
19a. the stateless any-hit predicate of row 6 (``bench_ladder.
    checker_pred``, a uv checker that also drops near-black surfaces)
    compiled by ``ops/anyhit_pred.py`` into a CUDA header: its hash and
    operations; K1's and K2's sources built with it (``kernels.load_pred``,
    both nvcc started together), nvcc's seconds and the predicate
    entries' ptxas lines beside the default libraries' (which build as
    before: their own lines are phase 2's); a second load builds nothing;
19b. K1's and K2's predicate modes against their plain versions (which
    call the predicate on tensors) on a 1-in-31 crop of row 6's 1080p
    camera rays, their shadow rays and (K1) the mixed ``occl_split``
    wave of both: every hit field and per-ray step equal to the bit;
    then each whole 512x512 wave (primary, shadow; K1 also mixed) through
    the bare launch, with the predicate's slot classes
    (``ops/pred_classes.py``, made once a table on the host: their counts
    printed) and with every slot forced to ``CLS_TEST`` (the parent's
    tests), both held to the bit against the plain walk of the same wave,
    and timed by CUDA events in turns with the alpha mode and the walk
    without any-hit on the same rays, beside the predicate mode's bound
    (``walk_bounds``: the tests and texel reads the classes leave, each
    with the predicate's operations; every candidate's beside), the
    candidates' shares by class and the plain walk's time;
19c. ladder row 6's scene with ``stateless_anyhit(checker_pred)``, launch
    counts reset before and read after: the 512x512 and 1080p frames
    through K1's predicate mode (8 ``traverse_packet_pred`` launches a
    frame), then, after a warm-up, one 512x512 frame on the 4-wide TLAS
    build through K2's (8 ``packet_walk_pred`` launches); ms a frame,
    rays; no K3 launch; both 512x512 frames against the suspension
    engine's (K3, the shader's callable) and K1's 1080p frame against
    K2's: equal rays, images within 2e-6;
19d. the 192x192 parity frame against the suspension engine
    (``packet_size=0``, K3 running the same shader's callable by rounds):
    the same rays and an image within 2e-6;
19e. ``bench_ladder.perforated_pred`` (round holes on a 12-cell uv grid,
    a ``sin`` x ``cos`` band and ``alpha ** 2.2``: ``sqrt``, ``sin``,
    ``cos`` and ``**`` correctly rounded, float64 rounded once) on 19's
    renderers: its variants built (nvcc seconds, the predicate entries'
    ptxas lines, its operations weighted by ``walk_bounds.pred_ops``),
    19b's checks and timings (every timed 512x512 wave, K1 primary,
    shadow and mixed, K2 primary and shadow, held to the plain walk of
    the same wave to the bit; a 1-in-61 crop of the 1080p waves through
    the wrappers) and 19c's frames (launch counts, the 512x512 frames
    against the suspension engine's, K1's 1080p frame against K2's:
    equal rays, within 2e-6), the waves' times beside the checker
    predicate's and the alpha mode's;
20a. K1 at width 16 (``RTConfig(bvh_width=16, flatten=True)``, 40-word
    rows, host-built): the ptxas lines of its six width-16 entries (the
    default library's four, the checker predicate build's two), and its
    8-wide default and alpha entries' lines equal to those before the
    width-16 entries existed (``K1_PTXAS_W8``; the predicate entries'
    lines printed);
20b. config 3's 1080p primary wave and the five waves of a config-4
    sample pass (``PT_WAVES``), captured from the 16-wide frame: K1 at
    width 16 against the plain walk on the card (hits and per-ray steps
    equal; the counting instantiation's internal steps equal the plain
    count), against the 8-wide K1 on the same rays (a ray that differs
    must be an exact-t tie, counted), both widths timed in turns (CUDA
    events around the bare launch) beside their bounds, with steps, and
    internal and leaf steps, a walking ray (``k1_timing.
    width_pair_wave``); the plain walk timed on each primary wave; the
    counters of a counting copy of the 16-wide step
    (``walk_timing.W16_COUNTS``): children a step, hit children m and
    ties between two hit keys, a lane's mean and a warp's maximum;
20c. the config-4 (and config-3) 1080p path-traced frame at width 16,
    launch counts reset before and read after (40 / 20
    ``traverse_packet16`` launches, no other walk), against the 8-wide
    frame: equal rays, the image within 1e-5; both widths' ms a frame in
    turns; ``perf_trace`` at width 16 (4 ``traverse_packet16_stats``
    launches) and the counting instantiation's time on config 4's primary
    wave;
20d. row 6's scene at width 16 with ``alpha_test_anyhit(0.30)`` and with
    ``stateless_anyhit(checker_pred)``: the 512x512 frame through the
    16-wide alpha and predicate modes (8 launches, no K3) against the
    suspension engine's (equal rays, within ``PRED_TOL``), each mode's
    primary wave against the plain walk, timed beside its bound;
16. prints the kernels' JSON line (per kernel: launches on its main-path
    run and per frame, K1's being config 4's frame with the other paths'
    counts beside it, the LBVH kernels' being row 5's run, the PLOC
    kernels' row 3's (six builds: a warm-up and five timed), with config
    5's build and refit beside them, one per ``__global__`` function
    launched, per frame from the counts over the run's refits; the
    largest difference from the plain version that the phases above
    measured; device time by CUDA events (K2's 1080p wave of 15d beside
    its config-2 wave), plain time, bound, what bounds it and the share
    of the bound;
    ``traverse_wide``'s launches the parity
    frame's (its suspension rounds, in place), the chunked frame's beside
    them, the alpha modes' the row-6 frames'; ``traverse_packet_alpha``
    and ``packet_walk_alpha`` are K1's and K2's alpha instantiations, with
    their time without alpha beside; ``traverse2``'s launches MK-A's
    timed frames', its time on MK-A's primary wave; ``lbvh_sah``'s the
    launch of one build at config 3's mesh, its time the whole sweep's,
    the kernel's beside, its host reads and device operations;
    ``traverse_packet_stats`` and ``packet_walk_stats`` the counting
    instantiations' launches on the CLI's and ``perf_trace``'s paths,
    their time on the CLI's config-2 primary wave beside the default
    instantiation's; ``traverse_packet_pred`` and ``packet_walk_pred``
    the predicate modes' launches on 19c's frames, their time on row 6's
    512x512 primary wave, the alpha mode's and the walk's without any-hit
    beside; ``traverse_packet16`` and its ``_alpha``, ``_pred`` and
    ``_stats`` modes K1's width-16 entries: launches on 20c's config-4
    frame, 20d's row-6 frames and 20c's ``perf_trace``, times on config
    4's primary wave and row 6's 512x512 primary wave, the 8-wide
    entry's beside) and, last, the device JSON line.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

from vortex_rt_tpu_torch.models.config2 import (
    LIGHT2, config2_camera, config2_scene,
)

SOURCES = {
    "packet_walk": ("vortex_rt_tpu_torch/csrc/packet_walk.cu",
                    "vortex_rt_tpu/ops/pallas/packet_walk.py:66"),
    "traverse_packet": ("vortex_rt_tpu_torch/csrc/traverse_packet.cu",
                        "vortex_rt_tpu/ops/traverse_packet.py:202"),
    "hbm_walk": ("vortex_rt_tpu_torch/csrc/hbm_walk.cu",
                 "tools/exp_pallas_hbm.py:57"),
    "lbvh_karras": ("vortex_rt_tpu_torch/csrc/lbvh_karras.cu",
                    "vortex_rt_tpu/accel/lbvh.py:112"),
    "lbvh_collapse": ("vortex_rt_tpu_torch/csrc/lbvh_collapse.cu",
                      "vortex_rt_tpu/accel/lbvh.py:326"),
    "lbvh_refit": ("vortex_rt_tpu_torch/csrc/lbvh_refit.cu",
                   "vortex_rt_tpu/accel/lbvh.py:284"),
    "lbvh_pack": ("vortex_rt_tpu_torch/csrc/lbvh_pack.cu",
                  "vortex_rt_tpu/accel/lbvh.py:466"),
    "ploc_merge": ("vortex_rt_tpu_torch/csrc/ploc_merge.cu",
                   "vortex_rt_tpu/accel/ploc.py:89"),
    "ploc_collapse": ("vortex_rt_tpu_torch/csrc/ploc_collapse.cu",
                      "vortex_rt_tpu/accel/ploc.py:223"),
    "ploc_refit": ("vortex_rt_tpu_torch/csrc/ploc_refit.cu",
                   "vortex_rt_tpu/accel/ploc.py:316"),
    # lbvh_pack.cu's survivor records, and its leaf kernel in its
    # explicit-ids mode
    "ploc_pack": ("vortex_rt_tpu_torch/csrc/lbvh_pack.cu",
                  "vortex_rt_tpu/accel/ploc.py:335"),
    # K3, and the alpha-cutout instantiations of K1 and K2 (the JAX
    # in-loop alpha test of trace_packets)
    "traverse_wide": ("vortex_rt_tpu_torch/csrc/traverse_wide.cu",
                      "vortex_rt_tpu/ops/traverse_wide.py:640"),
    "traverse_packet_alpha": ("vortex_rt_tpu_torch/csrc/traverse_packet.cu",
                              "vortex_rt_tpu/ops/traverse_packet.py:723"),
    "packet_walk_alpha": ("vortex_rt_tpu_torch/csrc/packet_walk.cu",
                          "vortex_rt_tpu/ops/traverse_packet.py:723"),
    # K6, the megakernel's binary TLAS+BLAS walk, and the sweep-SAH tree
    "traverse2": ("vortex_rt_tpu_torch/csrc/traverse2.cu",
                  "vortex_rt_tpu/ops/traverse2.py:143"),
    "lbvh_sah": ("vortex_rt_tpu_torch/csrc/lbvh_sah.cu",
                 "vortex_rt_tpu/accel/lbvh.py:170"),
    # the counting instantiations of K1 and K2: the PacketStats the JAX
    # loop carries (stats=True)
    "traverse_packet_stats": ("vortex_rt_tpu_torch/csrc/traverse_packet.cu",
                              "vortex_rt_tpu/ops/traverse_packet.py:1181"),
    "packet_walk_stats": ("vortex_rt_tpu_torch/csrc/packet_walk.cu",
                          "vortex_rt_tpu/ops/traverse_packet.py:1181"),
    # the predicate modes of K1 and K2: the JAX in-loop anyhit_pred
    "traverse_packet_pred": ("vortex_rt_tpu_torch/csrc/traverse_packet.cu",
                             "vortex_rt_tpu/ops/traverse_packet.py:723"),
    "packet_walk_pred": ("vortex_rt_tpu_torch/csrc/packet_walk.cu",
                         "vortex_rt_tpu/ops/traverse_packet.py:1057"),
    # K1's width-16 entries (the JAX loop at w_ == 16: its three-word
    # stack and Batcher's network, :337-343, :78-102), in each mode
    "traverse_packet16": ("vortex_rt_tpu_torch/csrc/traverse_packet.cu",
                          "vortex_rt_tpu/ops/traverse_packet.py:202"),
    "traverse_packet16_alpha": ("vortex_rt_tpu_torch/csrc/traverse_packet.cu",
                                "vortex_rt_tpu/ops/traverse_packet.py:723"),
    "traverse_packet16_pred": ("vortex_rt_tpu_torch/csrc/traverse_packet.cu",
                               "vortex_rt_tpu/ops/traverse_packet.py:723"),
    "traverse_packet16_stats": ("vortex_rt_tpu_torch/csrc/traverse_packet.cu",
                                "vortex_rt_tpu/ops/traverse_packet.py:1181"),
}
LBVH_KERNELS = ("lbvh_karras", "lbvh_collapse", "lbvh_refit", "lbvh_pack")
PLOC_KERNELS = ("ploc_merge", "ploc_collapse", "ploc_refit", "ploc_pack")
# the __global__ functions of each K4 function, as the profiler names them
PLOC_KERNEL_NAMES = {
    "ploc_merge": ("merge_grid_kernel", "merge_tail_kernel"),
    "ploc_collapse": ("remap_collapse_kernel",),
    "ploc_refit": ("boxes_kernel",),
    "ploc_refit_climb": ("boxes_kernel",),
    "ploc_pack": ("pack_nodes_kernel", "pack_leaves_kernel"),
}
# the __global__ functions of each LBVH library, as the profiler names them
LBVH_KERNEL_NAMES = {
    "lbvh_karras": ("box_morton_kernel", "karras_kernel"),
    "lbvh_collapse": ("collapse_kernel",),
    "lbvh_refit": ("refit_tile_kernel",),
    "lbvh_pack": ("pack_nodes_kernel", "pack_leaves_kernel"),
}
# the redesigned kernels' readings before their redesign (PERF.md's
# kernel table; CUDA events around the wrapper, ms, NVIDIA H100 80GB HBM3
# at 700 W), printed beside this run's
EARLIER_MS = {"lbvh_karras": {"config5": 0.0801},
              "lbvh_collapse": {"config5": 0.2362},
              "lbvh_pack": {"config5": 0.6296},
              "lbvh_refit": {"config5": 0.2038},
              "ploc_merge": {"config3": 8.2440, "config5": 7.2190},
              "ploc_collapse": {"config3": 0.2801, "config5": 0.3037},
              "ploc_pack": {"config3": 0.1332, "config5": 1.1697}}
# K6's and K2's readings before their redesign (local-memory stacks, the
# JAX arrays' layout for K6), as this script times them: CUDA events
# around the bare launch, ms, the mean of two turns of
# tools/walk_timing.py (NVIDIA H100 80GB HBM3 at 700 W; PERF.md's kernel
# table), printed beside this run's
EARLIER_WALK_MS = {"mk_a_primary": 0.0629, "mk_a_bounce1": 0.0614,
                   "mk_b_primary": 0.2575, "k2_config2_primary": 0.0656,
                   "k2_atrium_tlas_1080p": 0.3756}
EARLIER = ("before the redesigns: row 3's PLOC build 6.4-12.96 ms with the "
           "merge's host loop, 2.0-3.0 ms with K4b in three kernels; K4a 216 "
           "/ 228 launches a build and a host read a round; K4b 3 kernels, 3 "
           "fills, a torch.cumsum and 2 elementwise ops a build; config 5's "
           "refit + repack 1.5097-2.2055 ms before the pack's redesign, "
           "1.3219-1.5783 ms with the whole-tree refit climb; config 5's "
           "LBVH build 3.02-3.13 ms with K5 B in three kernels, two "
           "torch.cumsum and four fills and the refit plan's torch ops at "
           "the first refit, K5 A's scene box in six torch ops")
REL_TOL = 1e-6
IMG_ATOL = 1e-5
K7_ROWS = (29140, 1048576)
K7_STEPS = 2000
K7_KS = "1,4,8,16,32"
K7_WORDS = "4,24,128"  # 16 B, 96 B (K1's internal step), 512 B (TPU row)
SCALE_CROP = 4 * 132 * 8 * 128 + 17  # rays of phase 9b
REFIT_CROP = 132 * 8 * 128 + 17      # rays of phase 11c's walk check
NATIVE_CROP = 512 * 512              # rays of phase 8b's hit comparison
PT_SMALL = (256, 144)                # frame of the path-traced plain route
PT_WAVES = ("closest0", "shadow0", "closest1", "merged1", "shadow2")
_T0 = time.perf_counter()  # the script's start, for the phase titles


def _check(ok, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def _phase(title: str) -> None:
    """Print a phase's title with the seconds since the script started."""
    print(f"{title} [{time.perf_counter() - _T0:.1f} s]")


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _elapsed_ms(fn, reps: int, device) -> float:
    """Mean wall time of ``fn`` over ``reps`` calls, device-synchronised."""
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) * 1e3 / reps


def _device_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` from CUDA events around ``reps`` calls,
    after a warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _host_syncs(fn) -> int:
    """The operations of ``fn()`` that make the host wait for the device
    (reads to the host among them), counted by PyTorch's warnings on
    synchronising CUDA operations."""
    import warnings

    import torch

    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    return sum("synchroniz" in str(w.message) for w in caught)


def _json_safe(x):
    """``x`` with every NaN or infinite float (a reading not measured)
    made None, so that the line is strict JSON."""
    if isinstance(x, dict):
        return {k: _json_safe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_json_safe(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def _kernel_events(run) -> list:
    """``profile_frames.kernel_events(run)`` for a reading beside the
    checks: [] (not measured) where every profiler session recorded no
    device activity, which sessions late in one process do now and then
    (PERF.md section 7); the correctness checks never rest on it."""
    from vortex_rt_tpu_torch.tools.profile_frames import kernel_events

    try:
        return kernel_events(run)
    except RuntimeError as e:
        if "recorded no device kernel time" not in str(e):
            raise
        print(f"  (not measured: {e})")
        return []


def _profiled_kernel_ms(fn, reps: int, names) -> dict:
    """Device time per launch of each kernel in ``names`` (matched in the
    kernel's name; each launches once a call of ``fn``), from
    ``torch.profiler`` over ``reps`` calls after a warm-up: the kernels
    alone, without the fills and library calls a wrapper makes around
    them or the gaps between launches.  The mean over the launches the
    session recorded (a late session may record part of them); NaN, not
    measured, where it recorded none."""
    import torch

    fn()
    torch.cuda.synchronize()
    ev = _kernel_events(lambda: [fn() for _ in range(reps)])
    out = {}
    for name in names:
        hit = [e for e in ev if name in e.key]
        n = sum(e.count for e in hit)
        out[name] = (sum(e.self_device_time_total for e in hit) / 1e3 / n
                     if n else float("nan"))
    return out


def _kind(kw) -> str:
    if kw.get("occl_split", 0):
        return "mixed"
    return "occlusion" if kw.get("occlusion", False) else "closest"


# ---------------------------------------------------------------- scenes

def tlas_scene():
    """Two meshes, two instances: a TLAS over BLASes with instance nodes."""
    from vortex_rt_tpu_torch import RTConfig, Scene
    from vortex_rt_tpu_torch.models.procedural import box, uv_sphere

    sc = Scene()
    sc.add_mesh(uv_sphere((0, 0, 0), 1.0, 12, 16))
    sc.add_mesh(box((0.5, 0.3, 0.5), 0.4))
    cfg = RTConfig()
    return sc.build(cfg), cfg


def scale_scene(native: bool = True):
    """The ladder's config-3 scene: blob(n=187), 69,938 triangles."""
    from vortex_rt_tpu_torch import RTConfig, Scene
    from vortex_rt_tpu_torch.models.bigscenes import blob

    sc = Scene()
    sc.add_instance(sc.add_mesh(blob(n=187)))
    cfg = RTConfig(flatten=True, use_native_build=native)
    return sc.build(cfg), cfg


def atrium_scene(flatten: bool = True):
    """The ladder's config-4 scene: atrium(), 259,594 triangles in 29
    meshes (native build); ``flatten=False`` keeps the TLAS over the 29
    BLASes, as the CLI builds it for the megakernel engine."""
    from vortex_rt_tpu_torch import RTConfig, Scene
    from vortex_rt_tpu_torch.models.bigscenes import atrium

    sc = Scene()
    for mesh, refl in atrium():
        sc.add_instance(sc.add_mesh(mesh), reflectivity=refl)
    cfg = RTConfig(flatten=flatten)
    return sc.build(cfg), cfg


def instances_scene():
    """Transformed instances: a box under a translation, a sphere under a
    translation and a scale, the box again rotated and scaled, the sphere
    again under the same transform (exact ties between instances)."""
    from vortex_rt_tpu_torch import RTConfig, Scene
    from vortex_rt_tpu_torch.models.procedural import box, uv_sphere
    from vortex_rt_tpu_torch.utils import vecmath as vm

    sc = Scene()
    mb = sc.add_mesh(box((0, 0, 0), 1.0))
    ms = sc.add_mesh(uv_sphere((0, 0, 0), 1.0, 16, 24))
    sphere_at = vm.mat4_translate([3, 0, 0]) @ vm.mat4_scale(1.5)
    sc.add_instance(mb, vm.mat4_translate([-3, 0, 0]))
    sc.add_instance(ms, sphere_at)
    sc.add_instance(mb, vm.mat4_translate([0, 3, 0])
                    @ vm.mat4_rotate([0, 0, 1], 0.6) @ vm.mat4_scale(0.7))
    sc.add_instance(ms, sphere_at)
    cfg = RTConfig()
    return sc.build(cfg), cfg


def camera_rays(cam, w: int, h: int, device):
    """Pixel-center camera rays of the frame's tile-major lane order."""
    import torch

    from vortex_rt_tpu_torch.engine import wavefront as wf
    from vortex_rt_tpu_torch.engine.megakernel import CameraArrays

    lane = torch.arange(w * h, dtype=torch.int64, device=device)
    pxi, pyi = wf._tile_pixel_ids(lane, w, 16, 8 if h % 16 else 16)
    pix = pyi * w + pxi
    ox, oy, oz, dx, dy, dz = wf._camera_from_pix(
        CameraArrays.from_camera(cam, device), w, h, pxi, pyi, pix,
        torch.zeros_like(pix), 1)
    return torch.stack([ox, oy, oz], 1), torch.stack([dx, dy, dz], 1)


# ---------------------------------------------------------------- phases

def compare_hits(label: str, got, want, steps_got, steps_want) -> float:
    """Kernel hits and per-ray steps against the plain version's (ids,
    hit split and steps exact, dist/bx/by within REL_TOL); returns the
    max abs error over dist (hit lanes), bx and by."""
    import torch

    from vortex_rt_tpu_torch.utils.config import LARGE_FLOAT

    _check(torch.equal(got.tri, want.tri), f"{label}: tri differs")
    _check(torch.equal(got.inst, want.inst), f"{label}: inst differs")
    _check(torch.equal(got.dist < LARGE_FLOAT, want.dist < LARGE_FLOAT),
           f"{label}: hit/miss (or occluded) split differs")
    hit = want.dist < LARGE_FLOAT
    err = 0.0
    for name, a, b in (("dist", got.dist[hit], want.dist[hit]),
                       ("bx", got.bx, want.bx), ("by", got.by, want.by)):
        _check(torch.allclose(a, b, rtol=REL_TOL, atol=0.0),
               f"{label}: {name} differs beyond rel {REL_TOL}")
        if a.numel():
            err = max(err, float((a - b).abs().max()))
    _check(torch.equal(steps_got, steps_want),
           f"{label}: per-ray steps differ from the plain version")
    print(f"  {label}: rays {hit.numel()} hit/occluded {int(hit.sum())} "
          f"max_abs_err {err:.3g} same_steps True")
    return err


def walk_cases(wa, device, size: int, mixed: bool):
    """(mode, o, d, kwargs) of the walk comparisons: camera rays in the
    closest, 1/3 inactive and half t_max-clamped modes, shadow rays from
    their hit points in occlusion mode, and (``mixed``) one wave of the
    shadow rays (occlusion) followed by the camera rays (closest)."""
    import torch

    from vortex_rt_tpu_torch.engine.wavefront import default_walk
    from vortex_rt_tpu_torch.utils.config import LARGE_FLOAT

    walk = default_walk(wa)
    cam = config2_camera()
    light = torch.tensor(LIGHT2, dtype=torch.float32, device=device)
    o, d = camera_rays(cam, size, size, device)
    n = o.shape[0]
    base, _ = walk(wa, o, d)
    hit = base.dist < LARGE_FLOAT
    _check(bool(hit.any()), "no camera ray hit the scene")
    lane = torch.arange(n, device=device)
    t_max = torch.where(hit & (lane % 2 == 0), base.dist * 0.5,
                        torch.full_like(base.dist, LARGE_FLOAT))
    hp = o + d * base.dist.clamp_max(1e18).unsqueeze(1)
    sl = light - hp
    dist_l = torch.sqrt((sl * sl).sum(1) + 1e-20)
    sd = sl / dist_l.unsqueeze(1)
    so, clamp = hp + sd * 1e-3, dist_l * (1.0 - 1e-3)
    cases = [
        ("closest", o, d, dict()),
        ("active", o, d, dict(active=lane % 3 != 0)),
        ("t_max", o, d, dict(t_max=t_max)),
        ("shadow", so, sd, dict(active=hit, t_max=clamp, occlusion=True)),
    ]
    if mixed:
        cases.append(("mixed", torch.cat([so, o]), torch.cat([sd, d]), dict(
            active=torch.cat([hit, lane % 3 != 0]),
            t_max=torch.cat([clamp, torch.full_like(clamp, LARGE_FLOAT)]),
            occl_split=n)))
    return cases


def phase_walk_vs_plain(device, scenes, walk, ref, size: int = 64,
                        mixed: bool = False) -> float:
    from vortex_rt_tpu_torch import WavefrontRenderer

    err = 0.0
    for label, (sb, cfg) in scenes:
        wa = WavefrontRenderer.from_buffers(sb, cfg, device=device).wa
        for mode, co, cd, kw in walk_cases(wa, device, size, mixed):
            k, ks = walk(wa, co, cd, **kw)
            _sync(device)
            p, ps = ref(wa, co, cd, **kw)
            _sync(device)
            err = max(err, compare_hits(f"{label}/{mode}", k, p, ks, ps))
    return err


def renderer_pair(device, scene, ref):
    """(kernel-route renderer, plain-route renderer) of a build."""
    from vortex_rt_tpu_torch import WavefrontRenderer

    sb, cfg = scene
    rk = WavefrontRenderer.from_buffers(sb, cfg, device=device)
    return rk, dataclasses.replace(rk, walk=ref)


def frame_vs_plain(label, rk, rp, params, size, device, cam=None):
    """Render one frame through both routes; returns (image, rays).
    ``size`` is the side of a square frame or (w, h); the camera is
    config 2's unless given."""
    import numpy as np

    w, h = (size, size) if isinstance(size, int) else size
    cam = cam or config2_camera()
    img_k, rays_k = rk.render(cam, params, w, h)
    _sync(device)
    img_p, rays_p = rp.render(cam, params, w, h)
    _sync(device)
    _check(rays_k == rays_p, f"{label}: ray counts differ: {rays_k} vs "
           f"{rays_p}")
    _check(img_k.shape == (h, w, 3) and np.isfinite(img_k).all(),
           f"{label}: kernel-route image is not a finite (H, W, 3) image")
    diff = float(np.abs(img_k - img_p).max())
    _check(diff <= IMG_ATOL, f"{label}: images differ by {diff} > {IMG_ATOL}")
    print(f"  {label}: rays {rays_k} image max diff vs plain {diff:.3g}")
    return img_k, rays_k


def phase_small_frame_k2(device, size: int = 64) -> None:
    from vortex_rt_tpu_torch import RenderParams
    from vortex_rt_tpu_torch.ops.packet_walk import trace_packets_walk_ref
    from vortex_rt_tpu_torch.runtime import kernels

    rk, rp = renderer_pair(device, config2_scene(width=4),
                           trace_packets_walk_ref)
    p = RenderParams(light_pos=LIGHT2, max_depth=2, shadow=True, spp=2)
    before = kernels.LAUNCHES["packet_walk"]
    frame_vs_plain(f"4-wide {size}x{size} spp2 d2", rk, rp, p, size, device)
    launched = kernels.LAUNCHES["packet_walk"] - before
    if device.type == "cuda":
        # primary, shadow-0, bounce-1, shadow-1 per sample pass
        _check(launched == 4 * p.spp, f"{launched} K2 launches per frame")
    print(f"  K2 launches per frame {launched}")


def phase_small_frame_k1(device, size: int = 64) -> None:
    from vortex_rt_tpu_torch import RenderParams
    from vortex_rt_tpu_torch.ops.traverse_packet import (
        trace_packets, trace_packets_ref,
    )
    from vortex_rt_tpu_torch.runtime import kernels

    rk, rp = renderer_pair(device, config2_scene(sphere_refl=0.5),
                           trace_packets_ref)
    waves = []

    def walk(*a, **kw):
        waves.append(_kind(kw))
        return trace_packets(*a, **kw)

    rk = dataclasses.replace(rk, walk=walk)
    p = RenderParams(light_pos=LIGHT2, max_depth=3, shadow=True, spp=2)
    before = kernels.LAUNCHES["traverse_packet"]
    frame_vs_plain(f"8-wide {size}x{size} spp2 d3", rk, rp, p, size, device)
    launched = kernels.LAUNCHES["traverse_packet"] - before
    _check(waves == ["closest", "occlusion", "closest", "mixed",
                     "occlusion"] * p.spp, f"unexpected waves {waves}")
    if device.type == "cuda":
        _check(launched == 5 * p.spp, f"{launched} K1 launches per frame")
    print(f"  K1 launches per frame {launched}, waves per pass "
          f"{waves[:5]}")


def primary_wave(device, wa, timed, ref, work, bound, size, reps) -> dict:
    """One primary wave: the kernel against its plain version ``ref``
    (``work`` returns the plain hits, steps and work), timed with CUDA
    events (``timed`` makes a function of no arguments that launches it)
    and beside its bound."""
    o, d = camera_rays(config2_camera(), size, size, device)
    call = timed(wa, o, d)
    k, ks = call()
    pp, ps, wk = work(wa, o, d)
    err = compare_hits(f"primary {size}x{size}", k, pp, ks, ps)
    b = bound(wk)
    # (a CPU rehearsal has no device time)
    ms = _device_ms(call, reps) if device.type == "cuda" else float("nan")
    plain_ms = _elapsed_ms(lambda: ref(wa, o, d), 3, device)
    print(f"  primary wave {size}x{size}: kernel {ms:.4f} ms (device), "
          f"plain {plain_ms:.4f} ms, mean steps per ray "
          f"{float(ks.float().mean()):.2f}, bound {b.ms:.4f} ms "
          f"({b.bound_by}: {b.ops} ops, {b.bytes} B) = {b.ms / ms:.1%}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b.ms,
                bound_by=b.bound_by)


def main_path_run(label, rk, rp, params, size, device, name) -> int:
    """The path's run with launch counts reset just before and read just
    after; checked against the plain route.  Returns the launches."""
    import numpy as np

    from vortex_rt_tpu_torch.runtime import kernels

    kernels.reset_launches()
    img, rays = rk.render(config2_camera(), params, size, size)
    _sync(device)
    launches = dict(kernels.LAUNCHES)
    if device.type == "cuda":
        _check(launches[name] > 0, f"{label}: the path launched no {name}")
    _check(img.shape == (size, size, 3) and np.isfinite(img).all(),
           f"{label}: image is not a finite (H, W, 3) image")
    _check(rays >= size * size * params.spp,
           f"{label}: ray count {rays} below primaries")
    img_p, rays_p = rp.render(config2_camera(), params, size, size)
    _check(rays_p == rays, f"{label}: ray count {rays} vs plain {rays_p}")
    diff = float(np.abs(img - img_p).max())
    _check(diff <= IMG_ATOL, f"{label}: images differ by {diff}")
    print(f"  {label}: rays {rays} launches {launches} image max diff vs "
          f"plain {diff:.3g}")
    return launches[name]


def phase_config2(device, size: int = 512, wave_reps: int = 20) -> dict:
    from vortex_rt_tpu_torch.ops.traverse_packet import (
        kernel_call, trace_packets, trace_packets_ref, walk_work,
    )
    from vortex_rt_tpu_torch.tools import bench_ladder
    from vortex_rt_tpu_torch.tools import walk_bounds as wb

    row = bench_ladder.setup2(device, (size, size))
    rk, p, cam = row.r, row.p, row.cam
    rp = dataclasses.replace(rk, walk=trace_packets_ref)
    launches = main_path_run(f"config 2 {size}x{size} spp2 d2", rk, rp, p,
                             size, device, "traverse_packet")

    # ---- ladder row 2 on the same renderer: 3 x 16-frame bursts after a
    # warm-up (Mrays/s as the bench entry times it) and the golden parity
    row2 = ladder_row(device, row)
    mrays = row2["mrays"]
    bench_rec = bench_entry(device, row)
    timed = (kernel_call if device.type == "cuda"
             else lambda wa, o, d: lambda: trace_packets(wa, o, d))
    wave = primary_wave(device, rk.wa, timed, trace_packets_ref, walk_work,
                        wb.k1_bound, size, wave_reps)

    # ---- depth 3, reflective sphere: the merged wave with live lanes
    rk3, rp3 = renderer_pair(device, config2_scene(sphere_refl=0.5),
                             trace_packets_ref)
    p3 = dataclasses.replace(p, max_depth=3)
    _, rays3 = frame_vs_plain(f"config 2 reflective {size}x{size} spp2 d3",
                              rk3, rp3, p3, size, device)
    ms3 = _elapsed_ms(lambda: rk3.render(cam, p3, size, size), 3, device)
    print(f"  depth-3 frame {ms3:.3f} ms ({rays3} rays)")
    return dict(launches=launches, launches_per_frame=launches, mrays=mrays,
                row2=row2, bench=bench_rec, **wave)


def phase_config2_k2(device, size: int = 512, wave_reps: int = 20) -> dict:
    from vortex_rt_tpu_torch import RenderParams
    from vortex_rt_tpu_torch.ops.packet_walk import (
        kernel_call, trace_packets_walk, trace_packets_walk_ref, walk_work_4,
    )
    from vortex_rt_tpu_torch.tools import walk_bounds as wb

    rk, rp = renderer_pair(device, config2_scene(width=4),
                           trace_packets_walk_ref)
    _check(rk.walk is trace_packets_walk, "4-wide build is not on K2")
    p = RenderParams(light_pos=LIGHT2, max_depth=2, shadow=True, spp=2)
    launches = main_path_run(f"config 2 4-wide {size}x{size} spp2 d2", rk,
                             rp, p, size, device, "packet_walk")
    ms = _elapsed_ms(lambda: rk.render(config2_camera(), p, size, size), 3, device)
    print(f"  4-wide frame {ms:.3f} ms")
    timed = (kernel_call if device.type == "cuda"
             else lambda wa, o, d: lambda: trace_packets_walk(wa, o, d))
    wave = primary_wave(device, rk.wa, timed, trace_packets_walk_ref,
                        walk_work_4, wb.k2_bound, size, wave_reps)
    print(f"  K2 before its redesign (PERF.md): "
          f"{EARLIER_WALK_MS['k2_config2_primary']:.4f} ms on this wave")
    return dict(launches=launches, launches_per_frame=launches, **wave)


def phase_scale(device, scene, w: int = 1920, h: int = 1080) -> dict:
    import numpy as np
    import torch

    from vortex_rt_tpu_torch import RenderParams, Scene, WavefrontRenderer

    sb, cfg = scene
    t0 = time.perf_counter()
    r = WavefrontRenderer.from_buffers(sb, cfg, device=device)
    tables_s = time.perf_counter() - t0
    cam = Scene.framing_camera(sb, 45.0, w / h)
    p = RenderParams(max_depth=2, spp=2, shadow=True)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    img, _ = r.render_burst(cam, p, w, h, n_frames=1, seed0=0)
    _check(img.shape == (h, w, 3) and np.isfinite(img).all(),
           "scale-scene image is not a finite (H, W, 3) image")
    _sync(device)
    t0 = time.perf_counter()
    rays = r.render_burst(cam, p, w, h, n_frames=1, seed0=1, rays_only=True)
    dt = time.perf_counter() - t0
    _check(rays >= w * h * p.spp, f"ray count {rays} below primaries")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    out = dict(tris=sb.num_tris, width=r.wa.width,
               nodes=int(r.wa.nodes.shape[0]), depth=r.wa.depth,
               fused_bytes=r.wa.fused.numel() * 4,
               table_bytes=r.wa.nbytes + r.sa.nbytes, rays=rays,
               frame_ms=dt * 1e3, mrays=rays / dt / 1e6,
               peak_bytes=int(peak), tables_s=tables_s)
    print(f"  scale scene {w}x{h} spp2 d2 shadow: {json.dumps(out)}")
    if device.type == "cuda":
        out["waves"] = scale_waves(device, r, cam, p, w, h)
    return out, r


def capture_waves(r, cam, p, w: int, h: int, n: int) -> list:
    """The first ``n`` walk calls of one frame of ``r`` (``render_burst``,
    seed 0): [(o, d, kwargs)]."""
    import torch

    waves = []

    def capture(wa, o, d, **kw):
        if len(waves) < n:
            waves.append((o.clone(), d.clone(), {
                k: (v.clone() if torch.is_tensor(v) else v)
                for k, v in kw.items()}))
        return r.walk(wa, o, d, **kw)

    dataclasses.replace(r, walk=capture).render_burst(cam, p, w, h,
                                                      n_frames=1,
                                                      rays_only=True)
    _sync(r.device)
    return waves


def scale_waves(device, r, cam, p, w: int, h: int, reps: int = 10,
                names=None, label: str = "scale") -> dict:
    """The waves of the first sample pass of a frame (``names``; the
    Whitted scale frame's four unless given): K1 against the plain
    version on each (hits and steps), and its device time per wave beside
    the bound."""
    from vortex_rt_tpu_torch.ops.traverse_packet import kernel_call
    from vortex_rt_tpu_torch.tools import k1_timing

    names = names or k1_timing.SCALE_WAVES
    waves = capture_waves(r, cam, p, w, h, len(names))
    _check(len(waves) == len(names),
           f"a {label} pass made {len(waves)} waves")
    out = {}
    for name, (o, d, kw) in zip(names, waves):
        want = ("mixed" if name.startswith("merged") else "occlusion"
                if name.startswith("shadow") else "closest")
        _check(_kind(kw) == want, f"{label} {name} is a {_kind(kw)} wave")
        res = k1_timing.time_wave(r.wa, o, d, kw, {"k1": kernel_call}, reps)
        v = res.pop("versions")["k1"]
        res.update(ms=v["ms"], bound_share=v["bound_share"],
                   live=int(kw["active"].sum()) if "active" in kw
                   else o.shape[0])
        out[name] = res
        print(f"  {label} {name}: {res['rays']} lanes ({res['live']} live, "
              f"{res['walking_rays']} walking), steps mean "
              f"{res['mean_steps']:.3f} warp-max "
              f"{res['warp_max_steps']:.3f} (SIMT {res['simt_efficiency']:.1%})"
              f"; K1 {res['ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
              f"({res['bound_by']}) = {res['bound_share']:.1%}; hits and "
              f"steps equal the plain version")
    total = sum(v["ms"] for v in out.values())
    print(f"  K1 device time per sample pass {total:.4f} ms, per frame "
          f"{total * p.spp:.4f} ms")
    return out


def phase_scale_k1(device, r, w: int = 1920, h: int = 1080) -> float:
    """K1 against its plain version on the scale scene's tree (renderer
    ``r``), on a crop of camera rays and their shadow rays."""
    import torch

    from vortex_rt_tpu_torch import RenderParams, Scene
    from vortex_rt_tpu_torch.ops.traverse_packet import (
        trace_packets, trace_packets_ref,
    )
    from vortex_rt_tpu_torch.utils.config import LARGE_FLOAT

    sb, wa = r.sb, r.wa
    _check(wa.depth >= 9, f"scale tree depth {wa.depth} < 9")
    n = SCALE_CROP if device.type == "cuda" else 4113
    o, d = camera_rays(Scene.framing_camera(sb, 45.0, w / h), w, h, device)
    _check(o.shape[0] >= n, f"crop of {n} rays exceeds the frame")
    a = (o.shape[0] - n) // 2
    o, d = o[a:a + n].contiguous(), d[a:a + n].contiguous()
    base, _ = trace_packets_ref(wa, o, d)
    hit = base.dist < LARGE_FLOAT
    light = torch.tensor(RenderParams().light_pos, dtype=torch.float32,
                         device=device)
    hp = o + d * base.dist.clamp_max(1e18).unsqueeze(1)
    sl = light - hp
    dist_l = torch.sqrt((sl * sl).sum(1) + 1e-20)
    sd = sl / dist_l.unsqueeze(1)
    so, clamp = hp + sd * 1e-3, dist_l * (1.0 - 1e-3)
    lane = torch.arange(n, device=device)
    print(f"  depth {wa.depth}, {n} rays, {int(hit.sum())} camera hits")
    err = 0.0
    for mode, co, cd, kw in (
            ("closest", o, d, dict()),
            ("active", o, d, dict(active=lane % 3 != 0)),
            ("shadow", so, sd, dict(active=hit, t_max=clamp,
                                    occlusion=True)),
            ("mixed", torch.cat([so, o]), torch.cat([sd, d]), dict(
                active=torch.cat([hit, lane % 3 != 0]),
                t_max=torch.cat([clamp, torch.full_like(clamp, LARGE_FLOAT)]),
                occl_split=n))):
        k, ks = trace_packets(wa, co, cd, **kw)
        _sync(device)
        pp, ps = trace_packets_ref(wa, co, cd, **kw)
        err = max(err, compare_hits(f"scale/{mode}", k, pp, ks, ps))
    return err


def phase_native_build(device, w: int = 1920, h: int = 1080):
    """Build the native host builder and the two scale scenes with it;
    returns ((blob buffers, config), (atrium buffers, config))."""
    import torch

    from vortex_rt_tpu_torch import Scene, WavefrontRenderer
    from vortex_rt_tpu_torch.ops.traverse_packet import trace_packets
    from vortex_rt_tpu_torch.runtime import native
    from vortex_rt_tpu_torch.utils.config import LARGE_FLOAT

    native.load()
    print(f"  csrc/builder.cpp: {native.cxx_path()} "
          f"{' '.join(native.CXX_FLAGS)} in {native.build_seconds:.2f} s")
    timed = {}
    for name, make in (("blob native", scale_scene),
                       ("blob numpy", lambda: scale_scene(native=False)),
                       ("atrium native", atrium_scene)):
        t0 = time.perf_counter()
        timed[name] = make()
        sb = timed[name][0]
        print(f"  {name}: {sb.num_tris} triangles, "
              f"{sb.bvh_left.shape[0]} binary nodes, scene assembly and "
              f"build {time.perf_counter() - t0:.3f} s")
    # the native tree against the NumPy tree, by what camera rays hit
    sb = timed["blob native"][0]
    o, d = camera_rays(Scene.framing_camera(sb, 45.0, w / h), w, h, device)
    n = min(NATIVE_CROP, o.shape[0])
    a0 = (o.shape[0] - n) // 2
    o, d = o[a0:a0 + n].contiguous(), d[a0:a0 + n].contiguous()
    hits = [trace_packets(WavefrontRenderer.from_buffers(
        *timed[name], device=device).wa, o, d)[0]
        for name in ("blob native", "blob numpy")]
    a, b = hits
    hit = b.dist < LARGE_FLOAT
    _check(bool(hit.any()) and not bool(hit.all()),
           "the crop does not hold both hits and misses")
    _check(torch.equal(a.dist < LARGE_FLOAT, hit),
           "native and NumPy builds: hit masks differ")
    _check(torch.equal(a.tri[hit], b.tri[hit]),
           "native and NumPy builds: hit triangles differ")
    _check(torch.allclose(a.dist[hit], b.dist[hit], rtol=2e-4, atol=0.0),
           "native and NumPy builds: dist differs beyond 2e-4 relative")
    rel = float(((a.dist[hit] - b.dist[hit]).abs() / b.dist[hit]).max())
    print(f"  native vs NumPy build of the blob: {n} camera rays, "
          f"{int(hit.sum())} hits, same mask and tri, dist max rel diff "
          f"{rel:.3g}")
    return timed["blob native"], timed["atrium native"]


def phase_pathtraced(device, label: str, scene, spp: int, w: int = 1920,
                     h: int = 1080):
    """A ladder path-traced config at full width through K1, then the
    kernel route against the plain route at ``PT_SMALL``.  Returns
    (readings, renderer, camera, params)."""
    import numpy as np
    import torch

    from vortex_rt_tpu_torch import RenderParams, Scene, WavefrontRenderer
    from vortex_rt_tpu_torch.ops.traverse_packet import (
        trace_packets, trace_packets_ref,
    )
    from vortex_rt_tpu_torch.runtime import kernels

    sb, cfg = scene
    t0 = time.perf_counter()
    r = WavefrontRenderer.from_buffers(sb, cfg, device=device)
    tables_s = time.perf_counter() - t0
    _check(r.wa.width == 8 and r.wa.fused is not None
           and r.walk is trace_packets, f"{label} is not on the K1 route")
    cam = Scene.framing_camera(sb, 45.0, w / h)
    p = RenderParams(max_depth=3, spp=spp, shadow=True, pathtrace=True)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    # warm-up frame; its image is the one checked
    img, _ = r.render_burst(cam, p, w, h, n_frames=1, seed0=100)
    _check(img.shape == (h, w, 3) and np.isfinite(img).all()
           and float(img.std()) > 0.0,
           f"{label}: image is not a finite, non-constant (H, W, 3) image")
    _sync(device)
    kernels.reset_launches()
    t0 = time.perf_counter()
    rays = r.render_burst(cam, p, w, h, n_frames=1, seed0=200, rays_only=True)
    dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    _check(rays >= 2 * w * h * spp, f"{label}: {rays} rays, under two per "
           f"sample")
    if device.type == "cuda":
        # closest 0, shadow 0, closest 1, merged shadow 1 + closest 2,
        # shadow 2 per sample pass
        _check(launches == {**{k: 0 for k in launches},
                            "traverse_packet": 5 * spp},
               f"{label}: launches {launches}, expected {5 * spp} of K1")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    out = dict(tris=sb.num_tris, nodes=int(r.wa.nodes.shape[0]),
               depth=r.wa.depth, fused_bytes=r.wa.fused.numel() * 4,
               table_bytes=r.wa.nbytes + r.sa.nbytes, tables_s=tables_s,
               rays=rays, rays_per_sample=rays / (w * h * spp),
               frame_ms=dt * 1e3, mrays=rays / dt / 1e6,
               peak_bytes=int(peak),
               k1_launches=launches["traverse_packet"])
    print(f"  {label} {w}x{h} spp{spp} d3 shadow pathtrace: "
          f"{json.dumps(out)}")
    sw, sh = PT_SMALL if device.type == "cuda" else (32, 18)
    frame_vs_plain(
        f"{label} {sw}x{sh} spp2 d3", r,
        dataclasses.replace(r, walk=trace_packets_ref),
        dataclasses.replace(p, spp=2), (sw, sh), device, cam=cam)
    return out, r, cam, p


def phase_render_accum(device, r, cam, p, size=PT_SMALL) -> None:
    """``render_accum(n_passes=2, spp=2)`` is the mean of the two passes'
    ``frame_body(total_spp=4)`` frames."""
    import numpy as np

    from vortex_rt_tpu_torch.engine import wavefront as wf
    from vortex_rt_tpu_torch.engine.megakernel import (
        CameraArrays, LightArrays,
    )

    w, h = size
    p = dataclasses.replace(p, spp=2)
    acc, rays = r.render_accum(cam, p, w, h, n_passes=2, seed0=5)
    frames = [wf.frame_body(
        r.wa, r.sa, CameraArrays.from_camera(cam, device),
        LightArrays.from_params(p, device), w, h, max_depth=p.max_depth,
        spp=p.spp, table=r._table_for(p), seed=5 + i, shadow=p.shadow,
        tile_w=r.config.tile_w, tile_h=r.config.tile_h, walk=r.walk,
        total_spp=2 * p.spp) for i in range(2)]
    mean = ((frames[0][0] + frames[1][0]) * 0.5).reshape(3, h, w)
    diff = float(np.abs(acc - mean.permute(1, 2, 0).cpu().numpy()).max())
    _check(acc.shape == (h, w, 3) and np.isfinite(acc).all(),
           "render_accum: not a finite (H, W, 3) image")
    _check(diff <= 1e-6, f"render_accum differs from the mean of its "
           f"passes' frames by {diff}")
    _check(rays == int(frames[0][1] + frames[1][1]),
           "render_accum: ray count is not the sum of its passes'")
    print(f"  render_accum {w}x{h} n_passes 2 spp 2: rays {rays}, max diff "
          f"vs the mean of two frame_body(total_spp=4) frames {diff:.3g}")


ROW_K1_PER_FRAME = {1: 2, 2: 8, 4: 40}  # waves a sample pass x spp


def ladder_row(device, row) -> dict:
    """A ladder row as ``bench_ladder.run_row`` runs it (timing, launches a
    frame, golden parity), launch counts reset just before and read just
    after: K1 ``ROW_K1_PER_FRAME`` times a frame and no other kernel,
    ``parity_ok``."""
    from vortex_rt_tpu_torch.ops.traverse_packet import trace_packets
    from vortex_rt_tpu_torch.runtime import kernels
    from vortex_rt_tpu_torch.tools import bench_ladder as bl

    label = f"row {row.num}"
    _check(row.r.wa.width == 8 and row.r.wa.fused is not None
           and row.r.walk is trace_packets,
           f"{label} is not on the 8-wide fused K1 route")
    kernels.reset_launches()
    rec = bl.run_row(row)
    _sync(device)
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    want = ROW_K1_PER_FRAME[row.num]
    if device.type == "cuda":  # (a CPU rehearsal launches nothing)
        _check(rec["launches_per_frame"] == {"traverse_packet": want},
               f"{label}: launches a frame {rec['launches_per_frame']}, "
               f"expected {want} of K1 and nothing else")
        _check(set(launches) == {"traverse_packet"},
               f"{label}: the run launched {launches}")
    _check(rec["parity_ok"], f"{label}: golden parity RMSE "
           f"{rec['parity_rmse']} (limit {bl.PARITY_RMSE})")
    rec["launches"] = launches.get("traverse_packet", 0)
    print(f"  {json.dumps(rec)}")
    return rec


def bench_entry(device, row) -> dict:
    """The bench entry (``tools/bench.py``, on the card: the default) on
    row 2's renderer, its counts reset before it: its JSON line parsed,
    K1 its only kernel, 8 launches a frame."""
    import contextlib
    import io

    from vortex_rt_tpu_torch.runtime import kernels
    from vortex_rt_tpu_torch.tools import bench
    from vortex_rt_tpu_torch.tools import bench_ladder as bl

    kernels.reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rec = bench.main([], row=row)
    _sync(device)
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    print(f"  bench entry: {json.dumps(line)}")
    _check(line == rec and {"metric", "value", "unit", "vs_baseline", "gpu",
                            "scene", "knobs"} <= set(line)
           and line["unit"] == "Mrays/s" and line["value"] > 0
           and line["vs_baseline"] == line["value"] / 200
           and (line["gpu"] is not None or device.type != "cuda"),
           f"the bench entry's line {line}")
    _check(device.type != "cuda" or launches == {
        "traverse_packet": 8 * bl.BURST * (bl.REPS + 1)},
        f"the bench entry launched {launches}")
    return dict(line, launches=launches.get("traverse_packet", 0))


def phase_ladder_rows(device, r4) -> dict:
    """Ladder rows 1 and 4 through ``ladder_row`` (row 2 is phase 7's):
    row 1's frame against the plain route at full size (equal rays, within
    1e-5); row 4 renders with phase 9d's renderer, whose frame phase 9d
    held to the plain route."""
    from vortex_rt_tpu_torch.ops.traverse_packet import trace_packets_ref
    from vortex_rt_tpu_torch.tools import bench_ladder as bl

    row1 = bl.setup1(device)
    out = {"row1": ladder_row(device, row1)}
    frame_vs_plain(f"row 1 {row1.res[0]}x{row1.res[1]}", row1.r,
                   dataclasses.replace(row1.r, walk=trace_packets_ref),
                   row1.p, row1.res, device, cam=row1.cam)
    del row1
    out["row4"] = ladder_row(device, bl.setup4(device, r=r4))
    return out


def lbvh_test_meshes(big: bool = True):
    """(name, v0, v1, v2) of phase 11a: a sphere, a soup and (``big``) a
    100k-triangle grid, as float32 NumPy arrays."""
    import numpy as np

    from vortex_rt_tpu_torch.models.bigscenes import wavy_grid
    from vortex_rt_tpu_torch.models.procedural import random_soup, uv_sphere

    meshes = [("uv_sphere", uv_sphere((0, 0, 0), 1.0, 16, 32)),
              ("random_soup(2000)", random_soup(np.random.default_rng(5),
                                                2000))]
    if big:
        meshes.append(("wavy_grid(n=225)", wavy_grid(n=225)))
    return [(name, m.v0, m.v1, m.v2) for name, m in meshes]


def _same_bits(label: str, got, want) -> float:
    """Tensors (or tuples of them) equal bit for bit.  Returns the largest
    absolute difference of two output words (as integers), which is 0
    when the check passes."""
    import torch

    if torch.is_tensor(got):
        got, want = (got,), (want,)
    _check(len(got) == len(want), f"{label}: {len(got)} vs {len(want)} "
           f"outputs")
    err = 0
    for k, (a, b) in enumerate(zip(got, want)):
        if a is None or b is None:
            _check(a is None and b is None, f"{label}[{k}]: one is missing")
            continue
        _check(a.shape == b.shape and a.dtype == b.dtype,
               f"{label}[{k}]: {a.dtype}{tuple(a.shape)} vs "
               f"{b.dtype}{tuple(b.shape)}")
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        n = int((a != b).sum())
        err = max(err, int((a.to(torch.int64) - b.to(torch.int64))
                           .abs().max()))
        _check(n == 0, f"{label}[{k}]: {n} of {a.numel()} words differ "
               f"(by at most {err})")
    return float(err)


def lbvh_vs_plain(label: str, v0, v1, v2, width: int, leaf: int, plans,
                  checked: dict, err: dict):
    """Each LBVH kernel against its plain version on the triangles ``v0,
    v1, v2`` (padded, on the card): the scene box, Morton codes and the
    Karras tree (A), the collapse with the refit plan (B), the bottom-up
    boxes over that plan (C), and the pack (D) once per entry of
    ``plans`` -- ``plans(topo)`` gives (name, ``_pack_rows`` options)
    pairs.  Every integer field and every output word equal, and a
    second launch gives the same words.  Adds the wrapper calls made to
    ``checked`` and folds the largest word difference into ``err``, both
    by library name.  Returns the topology."""
    import torch

    from vortex_rt_tpu_torch.accel import lbvh

    def fold(name, calls, *diffs):
        checked[name] += calls
        err[name] = max(err[name], *diffs)

    l = v0.shape[0]
    got = lbvh.scene_codes(v0, v1, v2)
    e0 = _same_bits(f"{label} box and codes", got,
                    lbvh.scene_codes_ref(v0, v1, v2))
    lcodes, order = torch.sort(got[0], stable=True)
    tree = lbvh._karras(lcodes, l)
    fold("lbvh_karras", 3, e0,
         _same_bits(f"{label} karras", tree, lbvh._karras_ref(lcodes, l)),
         _same_bits(f"{label} karras again", lbvh._karras(lcodes, l), tree))
    made, again = [], []
    col = lbvh._collapse_wide(*tree, l, leaf, width, state=made)
    e1 = _same_bits(f"{label} collapse", col,
                    lbvh._collapse_wide_ref(*tree, l, leaf, width))
    e2 = _same_bits(f"{label} collapse again", lbvh._collapse_wide(
        *tree, l, leaf, width, state=again), col)
    (surv, ch_old, arity, base, newid, row_lo, row_cnt, leaf_newid,
     parent) = col
    topo = lbvh.LBVHTopo(
        order=order.to(torch.int32), lchild=tree[0], rchild=tree[1],
        surv=surv, ch_old=ch_old, arity=arity, base=base, newid=newid,
        row_lo=row_lo, row_cnt=row_cnt, leaf_newid=leaf_newid, lo=tree[2],
        hi=tree[3], parent=parent)
    e3 = plan_vs_plain(label, topo, made[0])
    fold("lbvh_collapse", 2, e1, e2, e3, _same_bits(
        f"{label} plan again", tuple(again[0].plan or ()),
        tuple(made[0].plan or ())))
    lbvh.topo_state(topo, made[0])
    boxes = lbvh._refit_boxes(topo, v0, v1, v2)
    fold("lbvh_refit", 2,
         _same_bits(f"{label} refit boxes", boxes,
                    lbvh._refit_boxes_ref(topo, v0, v1, v2)),
         _same_bits(f"{label} refit boxes again",
                    lbvh._refit_boxes(topo, v0, v1, v2), boxes))
    if made[0].plan is not None:
        n = int(made[0].plan.arrived.count_nonzero())
        _check(n == 0, f"{label}: {n} refit counters left non-zero after "
               f"the refits")
    for name, kw in plans(topo):
        kw = dict(kw, leaf_size=leaf, width=width)
        got = lbvh._pack_rows(topo, *boxes, v0, v1, v2, **kw)
        fold("lbvh_pack", 2,
             _same_bits(f"{label} pack {name}", got,
                        lbvh._pack_rows_ref(topo, *boxes, v0, v1, v2, **kw)),
             _same_bits(f"{label} pack {name} again",
                        lbvh._pack_rows(topo, *boxes, v0, v1, v2, **kw), got))
    return topo


def plan_vs_plain(label: str, topo, made) -> float:
    """On the card, the refit state the collapse made of ``topo``
    (``made``): its plan equals ``_refit_plan``'s (torch ops and
    ``refit_plan_kernel``) and its records ``_refit_records_ref``'s word
    for word, its counters are zero, its leaf-row count is the used rows'.
    Returns the largest word difference (0)."""
    from vortex_rt_tpu_torch.accel import lbvh
    from vortex_rt_tpu_torch.runtime import kernels

    want = (topo.row_cnt > 0).sum()
    _check(made.num_leaves.dtype == want.dtype
           and int(made.num_leaves) == int(want),
           f"{label}: the collapse counts {int(made.num_leaves)} leaf rows, "
           f"not {int(want)}")
    if made.plan is None:   # (the CPU route makes none)
        return 0.0
    n = int(made.plan.arrived.count_nonzero())
    _check(n == 0, f"{label}: {n} refit counters left non-zero")
    tile = kernels.load("lbvh_refit").lib.vrt_lbvh_refit_tile()
    ref = lbvh._refit_plan(topo, tile)
    e = _same_bits(f"{label} refit plan", tuple(made.plan), tuple(ref))
    return max(e, _same_bits(f"{label} refit records", made.plan.rec,
                             lbvh._refit_records_ref(topo, tile // 2,
                                                     ref.gstart)))


def phase_lbvh_kernels(device, meshes, checked: dict, err: dict) -> None:
    """Phase 11a: ``lbvh_vs_plain`` on each mesh at widths 4 and 8, leaf 4
    and 8, full and compact pools, flat and (4-wide) TLAS layouts."""
    import torch

    from vortex_rt_tpu_torch.accel import lbvh

    for name, *verts in meshes:
        for width, leaf in ((4, 4), (8, 4), (8, 8), (4, 8)):
            v0, v1, v2 = (torch.from_numpy(v).to(device)
                          for v in lbvh.pad_tris(*verts, leaf))
            sizes = []

            def plans(topo):
                pool_rows, leaf_rows, surv_idx = lbvh.compact_plan(topo)
                sizes[:] = [pool_rows, leaf_rows, int(topo.surv.sum())]
                for pools, kw in (("full", dict()), ("compact", dict(
                        pool_rows=pool_rows, leaf_rows=leaf_rows,
                        surv_idx=surv_idx))):
                    for tlas in ((False, True) if width == 4 else (False,)):
                        yield (f"{pools} tlas={tlas}",
                               dict(kw, tlas=tlas, fused=not tlas))

            lbvh_vs_plain(f"{name} w{width} l{leaf}", v0, v1, v2, width,
                          leaf, plans, checked, err)
            print(f"  {name} w{width} l{leaf}: T {v0.shape[0]}, pool "
                  f"{sizes[0]} leaf rows {sizes[1]} survivors {sizes[2]}: "
                  f"box and codes, karras, collapse and refit plan, refit "
                  f"boxes and pack (full and compact pools) equal their "
                  f"plain versions word for "
                  f"word; relaunches give the same words")


def phase_config3_device_tree(device, host_c3: dict, checked: dict,
                              err: dict) -> dict:
    """Phase 11b: ladder row 3 on a tree built on the card (the tool's
    entry point, launch counts reset before and read after); then each
    LBVH kernel against its plain version at this path's shapes (the
    row's mesh, 8-wide, leaf 4, the full pool with fused rows)."""
    import torch

    from vortex_rt_tpu_torch.accel import lbvh
    from vortex_rt_tpu_torch.models import bigscenes
    from vortex_rt_tpu_torch.runtime import kernels
    from vortex_rt_tpu_torch.tools import bench_ladder
    from vortex_rt_tpu_torch.utils.config import RTConfig

    kernels.reset_launches()
    rec = bench_ladder.config3(device, method="karras")
    _sync(device)
    launches = dict(kernels.LAUNCHES)
    print(f"  {json.dumps(rec)}")
    h = rec["hits"]
    _check(h["same_mask"] and h["same_tri"] and h["same_dist"],
           f"device-built tree: camera-ray hits differ from the host-built "
           f"tree's: {h}")
    _check(rec["parity_ok"], "config 3 on the device-built tree failed")
    if device.type == "cuda":
        for name in LBVH_KERNELS + ("traverse_packet",):
            _check(launches[name] > 0, f"config 3's device build launched "
                   f"no {name}")
    print(f"  device-built tree: build {rec['lbvh_build_ms']:.4f} ms, "
          f"{h['rays']} camera rays, {h['hits']} hits, same mask, tri and "
          f"dist as over the host-built tree; mean steps per ray "
          f"{h['mean_steps_device_tree']:.3f} (host-built "
          f"{h['mean_steps_host_tree']:.3f}); frame {rec['ms_per_frame']:.3f}"
          f" ms, {rec['rays_per_frame']} rays, host-built tree's timed in "
          f"turns {rec['ms_per_frame_host_tree']:.3f} ms (phase 9c: "
          f"{host_c3['frame_ms']:.3f} ms, {host_c3['rays']} rays); same "
          f"seed-0 frame from both trees: {rec['rays_device_tree']} vs "
          f"{rec['rays_host_tree']} rays, image max diff "
          f"{rec['image_max_abs_vs_host_tree']:.3g}; launches {launches}")
    rec["launches"] = launches

    cfg = RTConfig(flatten=True)
    sb = bench_ladder._single_mesh(bigscenes.blob(n=187), cfg)
    verts = bench_ladder._device_verts(sb, cfg.max_leaf_tris, device)
    before = dict(err)
    lbvh_vs_plain("config 3", *verts, cfg.bvh_width, cfg.max_leaf_tris,
                  lambda topo: [("full fused", dict(fused=True))], checked,
                  err)
    _check(rec["pool_rows"] == 2 * verts[0].shape[0] - 1,
           f"config 3's pool has {rec['pool_rows']} rows, not the full "
           f"pool of {verts[0].shape[0]} triangles")
    print(f"  the four LBVH kernels at config 3's shapes (T "
          f"{verts[0].shape[0]}, {cfg.bvh_width}-wide, leaf "
          f"{cfg.max_leaf_tris}, full pool of {rec['pool_rows']} rows, fused"
          f" rows) equal their plain versions word for word: largest word "
          f"difference { {k: err[k] for k in LBVH_KERNELS} } (before this "
          f"phase { {k: before[k] for k in LBVH_KERNELS} })")
    return rec


def phase_config5(device, checked: dict, err: dict, grid: int = 708,
                  res=(1920, 1080), reps: int = 20) -> dict:
    """Phase 11c: ladder row 5 at full width.  The main path's run (the
    tool's entry points, launch counts reset before and read after), the
    refit tree's walk against the plain walk on a crop, and each LBVH
    kernel at this path's shapes (the compact plan, fused rows): held
    against its plain version word for word, then timed beside it and
    its bound."""
    import torch

    from vortex_rt_tpu_torch.accel import lbvh
    from vortex_rt_tpu_torch.ops.traverse_packet import (
        trace_packets, trace_packets_ref,
    )
    from vortex_rt_tpu_torch.runtime import kernels
    from vortex_rt_tpu_torch.tools import bench_ladder
    from vortex_rt_tpu_torch.tools import walk_bounds as wb

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    t0 = time.perf_counter()
    st = bench_ladder.setup_config5(device, grid)
    setup_s = time.perf_counter() - t0
    build_launches = dict(kernels.LAUNCHES)
    rec = bench_ladder.config5(device, grid, res, state=st)
    _sync(device)
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    rec.update(setup_s=setup_s, peak_bytes=int(peak))
    print(f"  {json.dumps(rec)}")
    _check(rec["parity_ok"], f"config 5: the t = 0 frame differs from the "
           f"host-built tree's by {rec['parity_max_abs']} (rays "
           f"{rec['rays_t0']} vs {rec['rays_host_tree']})")
    n_refits = len(bench_ladder.MOVED_TS) + 2   # warm-up, moved, t = 0 again
    per_frame = {k: (launches[k] - build_launches[k]) / n_refits
                 for k in LBVH_KERNELS}
    if cuda:
        # the topology builds (a warm-up and the timed ones), each box +
        # codes and karras, the collapse with the refit plan, the refit
        # over that plan, pack_nodes + pack_leaves
        b = bench_ladder.BUILD_REPS + 1
        want = {"lbvh_karras": 2 * b, "lbvh_collapse": b, "lbvh_refit": b,
                "lbvh_pack": 2 * b}
        _check(all(build_launches[k] == v for k, v in want.items()),
               f"config 5 build launches {build_launches}, expected {want}")
        _check(per_frame == {"lbvh_karras": 0, "lbvh_collapse": 0,
                             "lbvh_refit": 1, "lbvh_pack": 2}
               and launches["traverse_packet"] > 0,
               f"config 5 launches {launches}, per refit frame {per_frame}")
    print(f"  config 5 {rec['res']}: build {rec['lbvh_build_ms']:.4f} ms "
          f"(median of {bench_ladder.BUILD_REPS}), "
          f"refit {rec['refit_ms']:.4f} ms (median of "
          f"{len(bench_ladder.MOVED_TS)}), {rec['ms_per_frame']:.3f} ms/frame,"
          f" frame + refit {rec['frame_plus_refit_ms']:.3f} ms, "
          f"{rec['mrays']:.3f} Mrays/s, pool {rec['refit_pool_rows']} leaf "
          f"rows {rec['refit_leaf_rows']}, peak {rec['peak_bytes']} B; host "
          f"scene and tables {setup_s:.2f} s; launches {launches}")

    # ---- the refit tree's walk against the plain walk on a crop
    w, h = res
    wa = st.refit_frame(bench_ladder.MOVED_TS[-1])
    o, d = camera_rays(bench_ladder.camera5(st.sb, w, h), w, h, device)
    n = min(REFIT_CROP if cuda else 1041, o.shape[0])
    a0 = (o.shape[0] - n) // 2
    o, d = o[a0:a0 + n].contiguous(), d[a0:a0 + n].contiguous()
    k, ks = trace_packets(wa, o, d)
    _sync(device)
    pp, ps = trace_packets_ref(wa, o, d)
    walk_err = compare_hits("refit tree/closest", k, pp, ks, ps)
    hk, hs = trace_packets(st.host_wa, o, d)
    print(f"  steps per ray on the crop: refit LBVH tree mean "
          f"{float(ks.float().mean()):.3f} max {int(ks.max())}, host-built "
          f"SAH tree (rest mesh) mean {float(hs.float().mean()):.3f} (the "
          f"walk's stack holds {wa.depth + 4} entries)")
    del hk

    # ---- each kernel against its plain version at this path's shapes:
    # the rest mesh, so the tree is the one the run above built
    leaf, width = st.cfg.max_leaf_tris, st.cfg.bvh_width
    plan = dict(pool_rows=st.pool_rows, leaf_rows=st.leaf_rows,
                surv_idx=st.surv_idx, fused=width == 8)
    before = dict(err)
    topo = lbvh_vs_plain("config 5", *st.verts, width, leaf,
                         lambda topo: [("compact fused", plan)], checked, err)
    _same_bits("config 5: the topology built again", tuple(topo),
               tuple(st.topo))
    print(f"  the four LBVH kernels at config 5's shapes (T "
          f"{st.verts[0].shape[0]}, {width}-wide, leaf {leaf}, pool "
          f"{st.pool_rows} leaf rows {st.leaf_rows} survivor rows "
          f"{st.surv_idx.shape[0]}, fused rows) equal their plain versions "
          f"word for word, and the topology equals the run's: largest word "
          f"difference { {k: err[k] for k in LBVH_KERNELS} } (before this "
          f"phase { {k: before[k] for k in LBVH_KERNELS} })")
    del topo

    # ---- each kernel at this shape: device time, plain time, bound
    v0, v1, v2 = st.moved(bench_ladder.MOVED_TS[-1])
    topo, l = st.topo, v0.shape[0]
    plan.update(leaf_size=leaf, width=width)
    lcodes = torch.sort(lbvh.scene_codes(v0, v1, v2)[0], stable=True)[0]
    tree = (topo.lchild, topo.rchild, topo.lo, topo.hi)
    boxes = lbvh._refit_boxes(topo, v0, v1, v2)
    calls = {
        "lbvh_karras": (
            lambda: (lbvh.scene_codes(v0, v1, v2), lbvh._karras(lcodes, l)),
            lambda: (lbvh.scene_codes_ref(v0, v1, v2),
                     lbvh._karras_ref(lcodes, l))),
        "lbvh_collapse": (
            lambda: lbvh._collapse_wide(*tree, l, leaf, width),
            lambda: lbvh._collapse_wide_ref(*tree, l, leaf, width)),
        "lbvh_refit": (
            lambda: lbvh._refit_boxes(topo, v0, v1, v2),
            lambda: lbvh._refit_boxes_ref(topo, v0, v1, v2)),
        "lbvh_pack": (
            lambda: lbvh._pack_rows(topo, *boxes, v0, v1, v2, **plan),
            lambda: lbvh._pack_rows_ref(topo, *boxes, v0, v1, v2, **plan)),
    }
    tile = kernels.load("lbvh_refit").lib.vrt_lbvh_refit_tile() if cuda else 256
    bounds = wb.lbvh_bounds(l, width, leaf, st.pool_rows, st.leaf_rows,
                            st.surv_idx.shape[0], width == 8, tile)
    rows = {}
    for name, (call, plain) in calls.items():
        # ms: the whole wrapper by CUDA events, as the walks' rows are
        # timed: its kernels with the fills and prefix sums around them.
        # kernel_ms: the library's kernels alone, from the profiler
        ms = _device_ms(call, reps) if cuda else float("nan")
        parts = (_profiled_kernel_ms(call, reps, LBVH_KERNEL_NAMES[name])
                 if cuda else {})
        plain_ms = _elapsed_ms(plain, 2 if cuda else 1, device)
        b = bounds[name]
        rows[name] = dict(launches=launches[name],
                          launches_per_frame=per_frame[name],
                          launches_by_path={"config5_build": build_launches[name],
                                            "config5": launches[name]},
                          ms=ms, kernel_ms=parts, plain_ms=plain_ms,
                          bound_ms=b.ms, bound_by=b.bound_by)
        was = EARLIER_MS.get(name, {}).get("config5")
        print(f"  {name} at T {l}: {ms:.4f} ms (CUDA events around the "
              f"wrapper, mean of {reps}: its kernels and whatever it "
              f"enqueues around them), bound {b.ms:.4f} ms ({b.bytes} B) = "
              f"{b.ms / ms:.1%}"
              + (f" (before: {was} ms = {b.ms / was:.1%})" if was else "")
              + f"; kernels alone {sum(parts.values()):.4f} ms (profiler: "
              + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
              + f"); plain {plain_ms:.3f} ms")
    if cuda:
        # the refit's plan of a topology made elsewhere (a topology with
        # another parent array is another topology), at its first refit;
        # a build's comes from its collapse
        from vortex_rt_tpu_torch.tools.profile_frames import (
            kernel_events, ms_by_name,
        )

        fresh = topo._replace(parent=topo.parent.clone())
        r = rows["lbvh_refit"]
        r["plan_kernel_ms"] = ms_by_name(_kernel_events(
            lambda: lbvh._refit_boxes(fresh, v0, v1, v2)),
            ("refit_plan_kernel",), 1)["refit_plan_kernel"]
        r["plan_ms"] = _device_ms(lambda: lbvh._refit_plan(topo, tile), 5)
        print(f"  lbvh_refit's plan of a topology not built here (bridge, "
              f"its first refit): {r['plan_ms']:.4f} ms (CUDA events around "
              f"_refit_plan, mean of 5: torch ops and refit_plan_kernel, "
              f"{r['plan_kernel_ms']:.4f} ms by the profiler); a build's "
              f"plan comes from its collapse")
        del fresh
        # the device operations of K5 A and K5 B, and of a whole build
        front = {"scene_codes": lambda: lbvh.scene_codes(v0, v1, v2),
                 "_karras": lambda: lbvh._karras(lcodes, l),
                 "_collapse_wide": lambda: lbvh._collapse_wide(
                     *tree, l, leaf, width, state=[])}
        for fn_name, fn in front.items():
            ops = kernel_events(fn)
            names = [f"{e.key[:40]} x{e.count}" for e in ops]
            _check(sum(e.count for e in ops) == 1,
                   f"{fn_name} enqueues {names}, not one launch")
        build = kernel_events(lambda: lbvh.build_lbvh_topo(
            *st.verts, leaf_size=leaf, width=width))
        names = [f"{e.key[:48]} x{e.count}" for e in build]
        rec["build_device_ops"] = sum(e.count for e in build)
        rec["build_device_op_names"] = names
        # less the sort's own operations (torch.sort and the order's cast,
        # as the build enqueues them), the build is its six kernels
        codes0 = lbvh.scene_codes(*st.verts)[0]
        left = {e.key: e.count for e in build}
        for e in kernel_events(lambda: torch.sort(codes0, stable=True)[1].to(
                torch.int32)):
            left[e.key] = left.get(e.key, 0) - e.count
        ours = {k: v for k, v in left.items() if v}
        want = ("box_morton_kernel", "karras_kernel", "collapse_kernel",
                "refit_tile_kernel", "pack_nodes_kernel", "pack_leaves_kernel")
        _check(sorted(ours.values()) == [1] * len(want)
               and all(any(w in k for k in ours) for w in want),
               f"config 5's build enqueues more than its six kernels and the "
               f"sort's operations: {ours}")
        rec["build_sort_ops"] = rec["build_device_ops"] - len(want)
        print(f"  scene_codes, _karras and _collapse_wide enqueue one device "
              f"operation each; a build enqueues {rec['build_device_ops']} "
              f"(profiler), its six kernels and {rec['build_sort_ops']} of "
              f"the sort: " + ", ".join(names) + " (before: K5 B three "
              "kernels, two torch.cumsum and four fills, the plan's ~20 "
              "torch ops and its kernel at the first refit, the box's six "
              "torch ops)")
        # what the pack costs without the fused rows: it then writes only
        # nodes and tri_rows, the tables the 8-wide walk does not read
        unfused = dict(plan, fused=False)
        parts = _profiled_kernel_ms(
            lambda: lbvh._pack_rows(topo, *boxes, v0, v1, v2, **unfused),
            reps, LBVH_KERNEL_NAMES["lbvh_pack"])
        rec["pack_unfused_kernel_ms"] = sum(parts.values())
        print(f"  lbvh_pack without the fused rows (nodes and tri_rows only,"
              f" {128 * st.pool_rows + 64 * leaf * st.leaf_rows} B of "
              f"stores): kernels alone {sum(parts.values()):.4f} ms "
              f"(profiler: " + ", ".join(f"{k} {v:.4f}"
                                         for k, v in parts.items()) + ")")
    if cuda:
        # the device operations one refit + repack issues: its kernels and
        # whatever the wrappers enqueue around them (fills, reductions)
        kw = {k: plan[k] for k in ("pool_rows", "leaf_rows", "surv_idx",
                                   "leaf_size", "width")}
        ops = kernel_events(lambda: lbvh.refit_lbvh(topo, v0, v1, v2, **kw))
        names = [f"{e.key[:40]} x{e.count}" for e in ops]
        rec["refit_device_ops"] = sum(e.count for e in ops)
        _check(not any(w in e.key.lower() for e in ops
                       for w in ("fill", "reduce")),
               f"config 5's refit frame fills or reduces: {names}")
        print(f"  a refit + repack frame issues {rec['refit_device_ops']} "
              f"device operations (profiler): " + ", ".join(names)
              + " (the whole-tree climb also issued its counters' fill, "
              "and the leaf-row count's compare and sum)")
    print(f"  config 5's refit + repack {rec['refit_ms']:.4f} ms a frame "
          f"({EARLIER})")
    rec.update(kernels=rows, walk_err=walk_err,
               launches_k1=launches["traverse_packet"])
    return rec, st


def remap_collapse_ref(lk, rk, lvl, bmn, bmx, n_int, l: int, width: int):
    """K4b's plain version: the plain remap, then the plain collapse."""
    from vortex_rt_tpu_torch.accel import ploc

    rm = ploc._remap_ploc_ref(lk, rk, lvl, bmn, bmx, n_int, l)
    return (*rm, *ploc._collapse_ploc_ref(rm[0], rm[1], rm[5], n_int, l,
                                          width))


def _no_fills(call, refuse: bool = True):
    """``call()`` with every ``torch.empty`` block it takes full of 0xFF
    bytes, so that a word the kernels leave unwritten differs from the
    plain version's, and (``refuse``) with ``torch.zeros``, ``torch.full``
    and their ``_like`` forms refused: a fill around the kernels
    raises."""
    import torch

    saved = {n: getattr(torch, n) for n in ("empty", "empty_like", "zeros",
                                            "zeros_like", "full",
                                            "full_like")}

    def poisoned(make):
        def made(*args, **kwargs):
            t = make(*args, **kwargs)
            t.reshape(-1).view(torch.uint8).fill_(255)
            return t
        return made

    def refused(*args, **kwargs):
        raise RuntimeError("a fill around the kernels")

    try:
        torch.empty = poisoned(saved["empty"])
        torch.empty_like = poisoned(saved["empty_like"])
        for n in ("zeros", "zeros_like", "full", "full_like"):
            if refuse:
                setattr(torch, n, refused)
        return call()
    finally:
        for n, f in saved.items():
            setattr(torch, n, f)


def ploc_vs_plain(label: str, v0, v1, v2, width: int, leaf: int,
                  radius: int, checked: dict, err: dict):
    """Each K4 kernel against its plain version on the triangles ``v0,
    v1, v2`` (padded, on the card): the merge rounds (K4a), the remap and
    collapse (K4b), the leaf-row boxes and the refit over moved vertices
    (K4c: two refits in a row, each one launch into unfilled outputs, the
    second with no fill around it, the climb's counters zero after each),
    and the pack from explicit leaf ids (K4d).  Every
    output word equal (every ``PLOCTopo`` field, ``n_int`` and
    ``n_levels`` among them), a second launch gives the same words, and
    the refit at the build's vertices gives the build's tables.  Adds the
    wrapper calls made to ``checked`` and folds the largest word
    difference into ``err``, both by kernel row name.  Returns (nodes,
    topology, the merge's live counts)."""
    import torch

    from vortex_rt_tpu_torch.accel import lbvh, ploc
    from vortex_rt_tpu_torch.runtime import kernels

    def fold(name, calls, *diffs):
        checked[name] += calls
        err[name] = max(err[name], *diffs)

    l = v0.shape[0]
    order, cmin0, cmax0, tids0 = ploc.seed_clusters(v0, v1, v2, leaf)
    live = []
    merged = ploc._ploc_merge(cmin0, cmax0, tids0, l, l, leaf, radius, live)
    fold("ploc_merge", 2,
         _same_bits(f"{label} merge", merged, ploc._ploc_merge_ref(
             cmin0, cmax0, tids0, l, l, leaf, radius)),
         _same_bits(f"{label} merge again", ploc._ploc_merge(
             cmin0, cmax0, tids0, l, l, leaf, radius), merged))
    lk, rk, lvl, bmn, bmx, row_tids, row_cnt, n_int, _ = merged
    out = ploc._remap_collapse_ploc(lk, rk, lvl, bmn, bmx, n_int, l, width)
    fold("ploc_collapse", 2,
         _same_bits(f"{label} remap and collapse", out, remap_collapse_ref(
             lk, rk, lvl, bmn, bmx, n_int, l, width)),
         _same_bits(f"{label} remap and collapse again",
                    ploc._remap_collapse_ploc(lk, rk, lvl, bmn, bmx, n_int,
                                              l, width), out))
    rm, col = out[:6], out[6:]
    rows = ploc._row_boxes(v0, v1, v2, order, row_tids, row_cnt)
    fold("ploc_refit", 2,
         _same_bits(f"{label} row boxes", rows, ploc._row_boxes_ref(
             v0, v1, v2, order, row_tids, row_cnt)),
         _same_bits(f"{label} row boxes again", ploc._row_boxes(
             v0, v1, v2, order, row_tids, row_cnt), rows))
    lb, pt = ploc.build_ploc_topo(v0, v1, v2, leaf_size=leaf, width=width,
                                  radius=radius)
    cuda = v0.device.type == "cuda"
    _same_bits(f"{label} the build's topology", (
        *pt.topo[:8], pt.topo.row_cnt, pt.topo.parent, pt.leaf_tids,
        pt.level, pt.n_int), (
        order, *rm[:2], *col[:5], row_cnt, rm[5], row_tids, rm[2], n_int))
    moved = tuple(v + 0.25 * torch.sin(v.flip(1)) for v in (v0, v1, v2))

    def refit(first):
        # on the card: one launch into unfilled outputs; no fill around
        # it, but for the climb's counters at a topology's first refit
        before = kernels.LAUNCHES["ploc_refit"]
        out = (_no_fills(lambda: ploc._refit_boxes_ploc(pt, *moved),
                         refuse=not first) if cuda
               else ploc._refit_boxes_ploc(pt, *moved))
        _sync(v0.device)
        _check(not cuda or kernels.LAUNCHES["ploc_refit"] == before + 1,
               f"{label}: a refit frame's boxes took "
               f"{kernels.LAUNCHES['ploc_refit'] - before} launches, "
               f"expected 1")
        if cuda:
            arrived = lbvh.topo_state(pt.topo).ploc_arrived
            _check(not bool(arrived.any()),
                   f"{label}: the refit left its counters set")
        return out

    # two refits in a row: the counters reset themselves
    boxes = refit(True)
    fold("ploc_refit", 2,
         _same_bits(f"{label} refit boxes", boxes,
                    ploc._refit_boxes_ploc_ref(pt, *moved)),
         _same_bits(f"{label} refit boxes again", refit(False), boxes))
    kw = dict(leaf_size=leaf, width=width, fused=width == 8,
              leaf_tids=pt.leaf_tids)
    got = lbvh._pack_rows(pt.topo, *boxes, *moved, **kw)
    fold("ploc_pack", 2,
         _same_bits(f"{label} pack", got,
                    lbvh._pack_rows_ref(pt.topo, *boxes, *moved, **kw)),
         _same_bits(f"{label} pack again",
                    lbvh._pack_rows(pt.topo, *boxes, *moved, **kw), got))
    re0 = ploc.refit_ploc(pt, v0, v1, v2, leaf_size=leaf, width=width)
    _same_bits(f"{label} refit at the build's vertices",
               (re0.nodes, re0.tri_rows, re0.fused),
               (lb.nodes, lb.tri_rows, lb.fused))
    return lb, pt, live


def phase_ploc_kernels(device, meshes, checked: dict, err: dict) -> None:
    """Phase 12a: ``ploc_vs_plain`` on each mesh at widths 4 and 8, leaf 4
    and 8, radius 16, and on the last mesh also at radius 8."""
    import torch

    from vortex_rt_tpu_torch.accel import lbvh

    for k, (name, *verts) in enumerate(meshes):
        shapes = [(4, 4, 16), (8, 4, 16), (8, 8, 16), (4, 8, 16)]
        if k == len(meshes) - 1:
            shapes.append((8, 4, 8))
        for width, leaf, radius in shapes:
            v0, v1, v2 = (torch.from_numpy(v).to(device)
                          for v in lbvh.pad_tris(*verts, leaf))
            _, pt, live = ploc_vs_plain(
                f"{name} w{width} l{leaf} r{radius}", v0, v1, v2, width,
                leaf, radius, checked, err)
            print(f"  {name} w{width} l{leaf} r{radius}: T {v0.shape[0]}, "
                  f"{int(pt.n_levels)} rounds, {int(pt.n_int)} internals, "
                  f"{int((pt.topo.row_cnt > 0).sum())} leaf rows, depth "
                  f"{int(pt.wide_depth)}: merge, remap, collapse, row boxes, "
                  f"refit and pack equal their plain versions word for word;"
                  f" relaunches give the same words")


def ploc_times(label: str, v, width: int, leaf: int, radius: int, pt, live,
               reps: int, device) -> dict:
    """Each K4 function at these shapes: CUDA-event time around its
    wrapper (mean of ``reps`` after a warm-up), the plain version's wall
    time, and the bytes bound (``walk_bounds.ploc_bounds``).
    ``ploc_refit`` is the build's leaf-row boxes (the main path's call);
    ``ploc_refit_climb`` the refit's boxes of the whole tree.  The merge
    loop is also timed with its tail block from other live counts than
    ``tail_size`` (the grid alone down to one cluster, and a quarter of
    T), and each time printed beside its reading before the redesign at
    ``label``."""
    from vortex_rt_tpu_torch.accel import lbvh, ploc
    from vortex_rt_tpu_torch.tools import walk_bounds as wb

    v0, v1, v2 = v
    l = v0.shape[0]
    order, cmin0, cmax0, tids0 = ploc.seed_clusters(v0, v1, v2, leaf)
    merged = ploc._ploc_merge(cmin0, cmax0, tids0, l, l, leaf, radius)
    lk, rk, lvl, bmn, bmx, row_tids, row_cnt, n_int, _ = merged
    rec = (lk, rk, lvl, bmn, bmx, n_int, l, width)
    boxes = ploc._refit_boxes_ploc(pt, v0, v1, v2)
    kw = dict(leaf_size=leaf, width=width, fused=width == 8,
              leaf_tids=pt.leaf_tids)
    calls = {
        "ploc_merge": (
            lambda: ploc._ploc_merge(cmin0, cmax0, tids0, l, l, leaf, radius),
            lambda: ploc._ploc_merge_ref(cmin0, cmax0, tids0, l, l, leaf,
                                         radius)),
        "ploc_collapse": (lambda: ploc._remap_collapse_ploc(*rec),
                          lambda: remap_collapse_ref(*rec)),
        "ploc_refit": (
            lambda: ploc._row_boxes(v0, v1, v2, order, row_tids, row_cnt),
            lambda: ploc._row_boxes_ref(v0, v1, v2, order, row_tids,
                                        row_cnt)),
        "ploc_refit_climb": (
            lambda: ploc._refit_boxes_ploc(pt, v0, v1, v2),
            lambda: ploc._refit_boxes_ploc_ref(pt, v0, v1, v2)),
        "ploc_pack": (
            lambda: lbvh._pack_rows(pt.topo, *boxes, v0, v1, v2, **kw),
            lambda: lbvh._pack_rows_ref(pt.topo, *boxes, v0, v1, v2, **kw)),
    }
    bounds = wb.ploc_bounds(l, width, leaf, live)
    bounds["ploc_refit_climb"] = bounds["ploc_refit"]
    bounds["ploc_refit"] = bounds["ploc_refit_rows"]
    out = {}
    for name, (call, plain) in calls.items():
        # (a CPU rehearsal has no device time)
        cuda = device.type == "cuda"
        ms = _device_ms(call, reps) if cuda else float("nan")
        parts, other, ops = {}, [], float("nan")
        if cuda:
            # its kernels alone, and the rest of the device time (the
            # prefix sums and fills around them), from the profiler
            from vortex_rt_tpu_torch.tools.profile_frames import ms_by_name

            names = PLOC_KERNEL_NAMES[name]
            kern = _kernel_events(lambda: [call() for _ in range(reps)])
            parts = ms_by_name(kern, names, reps)
            other = [(e.key[:48], e.self_device_time_total / 1e3 / reps)
                     for e in kern if not any(n in e.key for n in names)][:3]
            # device operations a call (kernels, fills, copies); not
            # measured where the session recorded none, and a late session
            # may record part of them: a refit frame's boxes are at most
            # its one kernel, and nothing else
            ops = sum(e.count for e in kern) / reps if kern else float("nan")
            _check(name != "ploc_refit_climb" or (not other and not ops > 1),
                   f"{label}: a refit frame's boxes took {ops} device "
                   f"operations: {other}")
        plain_ms = _elapsed_ms(plain, 1, device)
        b = bounds[name]
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b.ms,
                         bound_by=b.bound_by, bound_bytes=b.bytes,
                         kernel_ms=parts, other_ms=other, device_ops=ops)
        if cuda:
            # the host's time a call: the wrapper's pace when it is longer
            # than its kernels'
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(reps):
                call()
            out[name]["host_ms"] = (time.perf_counter() - t0) * 1e3 / reps
            _sync(device)
        was = EARLIER_MS.get(name, {}).get(label)
        print(f"  {name} at T {l}: {ms:.4f} ms (CUDA events around the "
              f"wrapper, mean of {reps}), bound {b.ms:.4f} ms ({b.bytes} B)"
              f" = {b.ms / ms:.1%}"
              + (f" (before: {was} ms = {b.ms / was:.1%})" if was else "")
              + "; kernels alone "
              f"{sum(parts.values()):.4f} ms (profiler: "
              + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
              + "; besides them " + ", ".join(f"{k} {v:.4f}"
                                              for k, v in other)
              + f"); plain {plain_ms:.3f} ms"
              + (f"; host {out[name]['host_ms']:.4f} ms a call" if cuda
                 else ""))
    if device.type == "cuda":
        print(f"  a refit frame's device operations at T {l}: "
              f"{out['ploc_refit_climb']['device_ops']}")
        t = ploc.tail_size(leaf)
        tails = {f"T={t}": t, f"T/4={t // 4}": t // 4, "grid only (T=2)": 2}
        out["ploc_merge"]["tail_ms"] = {k: _device_ms(
            lambda n=n: ploc._merge_on_card(cmin0, cmax0, tids0, l, l, leaf,
                                            radius, n), reps)
            for k, n in tails.items()}
        print(f"  ploc_merge by the live count where the tail block takes "
              f"over (CUDA events around the launch and its fills, mean of "
              f"{reps}): " + ", ".join(
                  f"{k} {v:.4f} ms" for k, v in
                  out["ploc_merge"]["tail_ms"].items()))
    return out


def three_tree_steps(label: str, trees: dict, o, d, ref: str, **kw) -> dict:
    """K1 over each tree of ``trees`` (name -> WideArrays of one mesh) on
    the rays ``o, d``: hits equal to tree ``ref``'s to the bit (mask,
    ``tri``, ``dist``), and steps per ray (mean, max) on each."""
    import torch

    from vortex_rt_tpu_torch.ops.traverse_packet import trace_packets
    from vortex_rt_tpu_torch.utils.config import LARGE_FLOAT

    res, out = {}, {}
    for name, wa in trees.items():
        res[name] = trace_packets(wa, o, d, **kw)
    want = res[ref][0]
    for name, (h, st) in res.items():
        _check(torch.equal(h.dist < LARGE_FLOAT, want.dist < LARGE_FLOAT)
               and torch.equal(h.tri, want.tri)
               and torch.equal(h.dist, want.dist),
               f"{label}: hits over the {name} tree differ from the {ref} "
               f"tree's")
        out[name] = dict(mean=float(st.float().mean()), max=int(st.max()))
    hits = int((want.dist < LARGE_FLOAT).sum())
    print(f"  {label}: {o.shape[0]} rays, {hits} hit/occluded, the same "
          f"mask, tri and dist over every tree; steps per ray "
          + ", ".join(f"{k} mean {v['mean']:.3f} max {v['max']}"
                      for k, v in out.items())
          + "; ratio to " + ref + " " + ", ".join(
              f"{k} {v['mean'] / out[ref]['mean']:.3f}x"
              for k, v in out.items() if k != ref))
    return dict(rays=int(o.shape[0]), hits=hits, steps=out)


def phase_config3_ploc(device, host_c3: dict, checked: dict, err: dict,
                       reps: int = 10, blob_n: int = 187,
                       res=(1920, 1080)) -> dict:
    """Phase 12b: ladder row 3 as the ladder defines it, the tree built
    on the card by PLOC (the tool's entry point, launch counts reset
    before and read after); K1 over the 1080p camera rays on the PLOC,
    Karras and host SAH trees (hits equal, steps) and on the five waves of
    a sample pass over the PLOC tree; the K4 kernels against their plain
    versions at this path's shapes, then timed."""
    from vortex_rt_tpu_torch.accel import lbvh, ploc
    from vortex_rt_tpu_torch.engine.wavefront import WavefrontRenderer
    from vortex_rt_tpu_torch.models import bigscenes
    from vortex_rt_tpu_torch.models.scene import Scene
    from vortex_rt_tpu_torch.runtime import kernels
    from vortex_rt_tpu_torch.tools import bench_ladder
    from vortex_rt_tpu_torch.utils.config import RTConfig

    kernels.reset_launches()
    rec = bench_ladder.config3(device, blob_n=blob_n, res=res)
    _sync(device)
    launches = dict(kernels.LAUNCHES)
    print(f"  {json.dumps(rec)}")
    _check(rec["lbvh"] == "ploc", "bench_ladder row 3 did not build by PLOC")
    h = rec["hits"]
    _check(h["same_mask"] and h["same_tri"] and h["same_dist"],
           f"PLOC tree: camera-ray hits differ from the host-built tree's: "
           f"{h}")
    _check(rec["parity_ok"], "config 3 on the PLOC tree failed")
    if device.type == "cuda":
        for name in PLOC_KERNELS + ("lbvh_karras", "traverse_packet"):
            _check(launches[name] > 0, f"config 3's PLOC build launched no "
                   f"{name}")
        _check(launches["lbvh_collapse"] == launches["lbvh_refit"]
               == launches["lbvh_pack"] == 0,
               f"config 3's PLOC path launched Karras kernels: {launches}")
        # a build: the merge's grid and tail, one remap + collapse
        _check(2 * launches["ploc_collapse"] == launches["ploc_merge"],
               f"config 3: K4b launched more than once a build: {launches}")
    print(f"  PLOC tree (radius {rec['ploc_radius']}): build "
          f"{rec['lbvh_build_ms']:.4f} ms (median of 5), {rec['ploc_rounds']}"
          f" rounds, pool {rec['pool_rows']} rows, {rec['leaf_rows']} leaf "
          f"rows, {rec['internals']} internals, depth {rec['tree_depth']} "
          f"(walk stack for {rec['walk_depth']}); {h['rays']} camera rays, "
          f"{h['hits']} hits, same mask, tri and dist as the host-built tree;"
          f" steps mean {h['mean_steps_device_tree']:.3f} max "
          f"{h['max_steps_device_tree']} (host {h['mean_steps_host_tree']:.3f}"
          f" max {h['max_steps_host_tree']}); frame {rec['ms_per_frame']:.3f}"
          f" ms, {rec['mrays']:.3f} Mrays/s, {rec['rays_per_frame']} rays, "
          f"host-built tree's timed in turns "
          f"{rec['ms_per_frame_host_tree']:.3f} ms (turns "
          f"{rec['ms_per_frame_turns']}; phase 9c: "
          f"{host_c3['frame_ms']:.3f} ms); seed-0 "
          f"frame {rec['rays_device_tree']} vs {rec['rays_host_tree']} rays,"
          f" image max diff {rec['image_max_abs_vs_host_tree']:.3g}; "
          f"launches {launches}")
    rec["launches"] = launches

    cfg = RTConfig(flatten=True)
    sb = bench_ladder._single_mesh(bigscenes.blob(n=blob_n), cfg)
    leaf, width = cfg.max_leaf_tris, cfg.bvh_width
    verts = bench_ladder._device_verts(sb, leaf, device)
    lb, pt = ploc.build_ploc_topo(*verts, leaf_size=leaf, width=width)
    trees = {"sah": WavefrontRenderer.from_buffers(sb, cfg, device=device).wa,
             "ploc": ploc.wide_arrays_from_ploc(lb, pt, leaf, width),
             "karras": lbvh.build_wide_from_tris(sb, leaf_size=leaf,
                                                 width=width, device=device)}
    w, hh = res
    o, d = camera_rays(Scene.framing_camera(sb, 45.0, w / hh), w, hh, device)
    rec["steps"] = three_tree_steps("config 3 camera rays", trees, o, d,
                                    "sah")
    if device.type == "cuda":
        # K1 on the five waves of a sample pass over the PLOC tree, beside
        # phase 9c's over the host-built tree
        from vortex_rt_tpu_torch.models.scene import RenderParams

        r = WavefrontRenderer.from_buffers(sb, cfg, device=device)
        r.wa = trees["ploc"]
        rec["waves"] = scale_waves(
            device, r, Scene.framing_camera(sb, 45.0, w / hh),
            RenderParams(max_depth=3, spp=4, shadow=True, pathtrace=True),
            w, hh, reps=5, names=PT_WAVES, label="config 3 PLOC tree")
        del r
    del trees, o, d
    before = dict(err)
    _, pt2, live = ploc_vs_plain("config 3", *verts, width, leaf, 16,
                                 checked, err)
    print(f"  the K4 kernels at config 3's shapes (T {verts[0].shape[0]}, "
          f"{width}-wide, leaf {leaf}, radius 16, fused rows) equal their "
          f"plain versions word for word: largest word difference "
          f"{ {k: err[k] for k in PLOC_KERNELS} } (before this phase "
          f"{ {k: before[k] for k in PLOC_KERNELS} })")
    rec["times"] = ploc_times("config3", verts, width, leaf, 16, pt2, live,
                              reps, device)
    rec["live"] = live
    return rec


def merge_reads_nothing(verts, leaf: int, radius: int = 16) -> None:
    """The merge loop without ``live`` under
    ``torch.cuda.set_sync_debug_mode("error")``: a copy to the host
    raises."""
    import torch

    from vortex_rt_tpu_torch.accel import ploc

    l = verts[0].shape[0]
    _, cmin0, cmax0, tids0 = ploc.seed_clusters(*verts, leaf)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ploc._ploc_merge(cmin0, cmax0, tids0, l, l, leaf, radius)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def phase_config5_ploc(device, st, checked: dict, err: dict,
                       reps: int = 5, res=(1920, 1080)) -> dict:
    """Phase 12c: the PLOC build and refit at config 5's mesh (phase 11c's
    ``st``: wavy_grid(n=708), 999,700 triangles, 8-wide, leaf 4): build
    time and rounds, the refit at t = 0 against the build's tables, the
    refit time per frame with config 5's ripple, K1 steps over the PLOC,
    Karras and host SAH trees on phase 11c's crop and on shadow rays
    (hits equal), and the K4 kernels against their plain versions at this
    size, then timed."""
    import statistics

    import torch

    from vortex_rt_tpu_torch.accel import ploc
    from vortex_rt_tpu_torch.runtime import kernels
    from vortex_rt_tpu_torch.tools import bench_ladder
    from vortex_rt_tpu_torch.utils.config import LARGE_FLOAT

    leaf, width = st.cfg.max_leaf_tris, st.cfg.bvh_width
    verts = st.verts
    l = verts[0].shape[0]
    kernels.reset_launches()
    lb, pt = ploc.build_ploc_topo(*verts, leaf_size=leaf, width=width)
    _sync(device)
    build_launches = {k: kernels.LAUNCHES[k] for k in PLOC_KERNELS}
    built = {}

    def build():
        built["r"] = ploc.build_ploc_topo(*verts, leaf_size=leaf,
                                          width=width)

    build_ms = statistics.median(bench_ladder.timed_ms(build, device, 5))
    wa = ploc.wide_arrays_from_ploc(lb, pt, leaf, width)
    re0 = ploc.refit_ploc(pt, *verts, leaf_size=leaf, width=width)
    err_t0 = _same_bits("config 5 PLOC refit at t = 0",
                        (re0.nodes, re0.tri_rows, re0.fused),
                        (lb.nodes, lb.tri_rows, lb.fused))
    del re0, built
    kernels.reset_launches()
    refit_ms = []
    for t in bench_ladder.MOVED_TS:
        refit_ms += bench_ladder.timed_ms(
            lambda t=t: ploc.refit_ploc(pt, *st.moved(t), leaf_size=leaf,
                                        width=width), device)
    _sync(device)
    refit_launches = {k: kernels.LAUNCHES[k] / len(bench_ladder.MOVED_TS)
                      for k in PLOC_KERNELS + ("lbvh_pack",)}
    if device.type == "cuda":
        merge_reads_nothing(verts, leaf)
    rec = dict(tris=l, build_ms=build_ms, rounds=int(pt.n_levels),
               internals=int(pt.n_int),
               leaf_rows=int((pt.topo.row_cnt > 0).sum()),
               tree_depth=int(pt.wide_depth), walk_depth=wa.depth,
               refit_ms=statistics.median(refit_ms), refit_ms_all=refit_ms,
               refit_t0_err=err_t0, build_launches=build_launches,
               refit_launches=refit_launches, merge_host_reads=0)
    if device.type == "cuda":
        _check(build_launches["ploc_merge"] == 2
               and build_launches["ploc_collapse"] == 1,
               f"K4a, K4b: {build_launches['ploc_merge']}, "
               f"{build_launches['ploc_collapse']} launches a build, "
               f"expected 2, 1")
        _check(refit_launches["ploc_refit"] == 1
               and refit_launches["ploc_pack"] == 2
               and refit_launches["lbvh_pack"] == 0
               and refit_launches["ploc_merge"] == 0,
               f"PLOC refit launches per frame {refit_launches}")
    print(f"  PLOC at T {l}: build {build_ms:.4f} ms (median of 5, CUDA "
          f"events), {rec['rounds']} rounds, {rec['internals']} internals, "
          f"{rec['leaf_rows']} leaf rows, depth {rec['tree_depth']} (walk "
          f"stack for {wa.depth}); refit + repack + fused rows at t = 0 "
          f"equals the build word for word; refit with the ripple "
          f"{rec['refit_ms']:.4f} ms (median of {len(refit_ms)}: "
          + ", ".join(f"{x:.4f}" for x in refit_ms) + f"); build launches "
          f"{build_launches} (K4a {build_launches['ploc_merge']}, no host "
          f"read in the merge), per refit {refit_launches}; {EARLIER}")

    # ---- K1 over the three trees on phase 11c's crop and shadow rays
    w, h = res
    o, d = camera_rays(bench_ladder.camera5(st.sb, w, h), w, h, device)
    n = min(REFIT_CROP, o.shape[0])
    a0 = (o.shape[0] - n) // 2
    o, d = o[a0:a0 + n].contiguous(), d[a0:a0 + n].contiguous()
    trees = {"sah": st.host_wa, "ploc": wa, "karras": st.refit_frame(0.0)}
    rec["crop"] = three_tree_steps("config 5 crop, camera rays", trees, o, d,
                                   "sah")
    from vortex_rt_tpu_torch.ops.traverse_packet import trace_packets

    hit, _ = trace_packets(st.host_wa, o, d)
    live_lane = hit.dist < LARGE_FLOAT
    p = o + d * torch.where(live_lane, hit.dist * 0.9999, 0.0)[:, None]
    light = torch.tensor(bench_ladder.LIGHT5, dtype=torch.float32,
                         device=device)
    to_l = light - p
    dist_l = to_l.norm(dim=1)
    sd = (to_l / dist_l[:, None]).contiguous()
    rec["shadow"] = three_tree_steps(
        "config 5 crop, shadow rays", trees, p.contiguous(), sd, "sah",
        occlusion=True, active=live_lane, t_max=dist_l.contiguous())
    del trees, o, d, p, sd

    before = dict(err)
    _, pt2, live = ploc_vs_plain("config 5", *verts, width, leaf, 16,
                                 checked, err)
    rec["live"] = live
    _same_bits("config 5: the PLOC topology built again",
               (*pt2.topo, *pt2[1:]), (*pt.topo, *pt[1:]))
    print(f"  the K4 kernels at config 5's mesh (T {l}) equal their plain "
          f"versions word for word, and the topology equals the first "
          f"build's: largest word difference "
          f"{ {k: err[k] for k in PLOC_KERNELS} } (before this phase "
          f"{ {k: before[k] for k in PLOC_KERNELS} })")
    rec["times"] = ploc_times("config5", verts, width, leaf, 16, pt, live,
                              reps, device)
    return rec


# ------------------------------------------------ any-hit path (13a-13d)

def cutout_scene(flatten: bool = False):
    """The any-hit test scene: two checkered quads and a dark quad before a
    sphere, a box and two instances of a triangle soup (TLAS over several
    BLASes unless flattened)."""
    import numpy as np

    from vortex_rt_tpu_torch import RTConfig, Scene
    from vortex_rt_tpu_torch.models.procedural import (
        box, quad, random_soup, uv_sphere,
    )
    from vortex_rt_tpu_torch.models.scene import Material
    from vortex_rt_tpu_torch.utils import vecmath as vm

    yy, xx = np.meshgrid(np.arange(12), np.arange(12), indexing="ij")
    tex = np.where(((xx // 3) + (yy // 3)) % 2 == 0, 0xFFFFFF,
                   0x101010).astype(np.uint32)
    sc = Scene()
    for mesh in (
            quad((-1.5, -1.5, 0), (1.5, -1.5, 0), (1.5, 1.5, 0),
                 (-1.5, 1.5, 0), Material(diffuse=(1, 1, 1), diffuse_tex=tex)),
            quad((-2, -2, 1.0), (2, -2, 1.0), (2, 2, 1.0), (-2, 2, 1.0),
                 Material(diffuse=(1, 1, 1), diffuse_tex=tex)),
            quad((-0.5, -0.5, 1.7), (0.5, -0.5, 1.7), (0.5, 0.5, 1.7),
                 (-0.5, 0.5, 1.7), Material(diffuse=(0.1, 0.1, 0.1))),
            uv_sphere((0, 0, 2.6), 0.8, 10, 14), box((1.2, 1.0, 2.4), 0.5)):
        sc.add_instance(sc.add_mesh(mesh))
    ms = sc.add_mesh(random_soup(np.random.default_rng(0), 3000, extent=2.0,
                                 tri_size=0.3))
    sc.add_instance(ms, vm.mat4_translate([0.5, 0, 4]))
    sc.add_instance(ms, vm.mat4_translate([-1, 0.5, 5])
                    @ vm.mat4_rotate([0, 1, 0], 0.5))
    return sc.build(RTConfig(flatten=flatten))


def pool_lanes(cam, w: int, h: int, spp: int, device):
    """The ray lanes of a pool frame's first wave (every sample of every
    pixel, a pixel's samples adjacent, tile-major): what the suspension
    engine's primary wave traces."""
    import torch

    from vortex_rt_tpu_torch.engine import wavefront as wf
    from vortex_rt_tpu_torch.engine.megakernel import CameraArrays

    lane = torch.arange(w * h * spp, dtype=torch.int64, device=device)
    q = lane // spp
    pxi, pyi = wf._tile_pixel_ids(q, w, 16, 16)
    return wf._camera_from_pix(CameraArrays.from_camera(cam, device), w, h,
                               pxi, pyi, pyi * w + pxi, lane % spp, spp)


def compare_states(label: str, got, want) -> float:
    """Every WideState field of K3 against the plain version's: equal to
    the bit.  Returns the largest difference (0.0)."""
    import torch

    for name, a, b in zip(got._fields, got, want):
        _check(torch.equal(a, b), f"{label}: state field {name} differs "
               f"from the plain version")
    return 0.0


def k3_loop(label, wa, lanes, device, action_fn, rounds: int = 1000) -> int:
    """K3 through ``trace_lanes`` (a copy of the state walked, the input
    unchanged), K3 in place on a state of its own (``walk_lanes``, the
    pool path's rounds) and the plain version from a fresh state through
    up to ``rounds`` suspension rounds (``action_fn(state)`` the commit
    actions), every state equal; returns the rounds run."""
    from vortex_rt_tpu_torch.ops import traverse_wide as tw

    st = sr = None
    si = tw.init_state_lanes(*lanes)
    for k in range(rounds):
        _, st, _ = tw.trace_lanes(wa, *lanes, state=st, suspend=True)
        si = tw.walk_lanes(wa, *lanes, state=si, suspend=True)
        _sync(device)
        _, sr, _ = tw.trace_lanes_ref(wa, *lanes, state=sr, suspend=True)
        compare_states(f"{label} round {k}", st, sr)
        compare_states(f"{label} round {k}, in place", si, sr)
        if not bool(st.suspended.any()):
            return k
        act = action_fn(st)
        st, sr, si = tw.commit(st, act), tw.commit(sr, act), tw.commit(si, act)
    return rounds


def alpha_actions(wa, sa, lanes, table):
    """The commit actions of ``table``'s any-hit shader at each suspended
    lane's pending hit, as the frame's pool computes them."""
    import torch

    from vortex_rt_tpu_torch.engine.shaders import (
        PayloadLanes, RayLanes, ShaderContext,
    )
    from vortex_rt_tpu_torch.ops.shade_lanes import shade_point

    def act(st):
        sp = shade_point(
            sa, *lanes, st.pend_t, st.pend_bx, st.pend_by,
            1.0 - st.pend_bx - st.pend_by,
            st.pend_tri.clamp(0, sa.shade_rows.shape[0] - 1).long(),
            st.pend_inst.clamp(0, sa.inst_shade.shape[0] - 1).long())
        z = torch.zeros_like(st.tri)
        a = table.anyhit(ShaderContext(sa, *(None,) * 4, 2), sp,
                         RayLanes(*lanes), PayloadLanes(z, z, z, z))
        return torch.where(st.suspended, a.to(torch.int32), 0)

    return act


def phase_k3(device, atrium6_tlas, cam6, table6, size: int = 128,
             crop: int = 96, parity: int = 192) -> dict:
    """13a: K3 against its plain version, then K3 timed at the parity
    frame's first wave beside its plain version and its bound."""
    import torch

    from vortex_rt_tpu_torch import Camera
    from vortex_rt_tpu_torch.ops import traverse_wide as tw
    from vortex_rt_tpu_torch.runtime import kernels
    from vortex_rt_tpu_torch.tools import walk_bounds as wb
    from vortex_rt_tpu_torch.utils.config import COMMIT_TERM

    # the cutout scene: auto-accept, then a suspension loop of mixed
    # actions (the near quad rejected, every 17th lane TERMinated)
    from vortex_rt_tpu_torch.ops.traverse_wide import WideArrays

    wa = WideArrays.from_scene(cutout_scene()).to(device)
    cam = Camera.look_at([0.15, -0.1, -3.0], [0, 0, 1], [0, 1, 0], 50.0,
                         1.0)
    lanes = pool_lanes(cam, size, size, 1, device)
    h, st, _ = tw.trace_lanes(wa, *lanes)
    _sync(device)
    hr, sr, _ = tw.trace_lanes_ref(wa, *lanes)
    compare_states("cutout/auto", st, sr)
    lane = torch.arange(lanes[0].shape[0], device=device)

    def mixed(s):
        a = torch.where(s.pend_inst == 0, 0, torch.where(
            lane % 17 == 0, COMMIT_TERM, 1)).to(torch.int32)
        return torch.where(s.suspended, a, 0)

    rounds = k3_loop("cutout/suspend", wa, lanes, device, mixed)
    print(f"  cutout (TLAS, {wa.nodes.shape[0]} nodes, depth {wa.depth}): "
          f"{lanes[0].shape[0]} rays, auto-accept mean steps "
          f"{float(st.nodes_visited.float().mean()):.3f}, "
          f"{int((h.dist < 1e30).sum())} hits; suspension loop {rounds} "
          f"rounds; every state field equals the plain version's")

    # a crop of the textured atrium's TLAS build: auto-accept and three
    # rounds of the alpha test's own actions
    r4 = atrium6_tlas
    wa6 = r4.wa
    crop_lanes = pool_lanes(cam6, crop, crop, 1, device)
    h, st, _ = tw.trace_lanes(wa6, *crop_lanes)
    _sync(device)
    _, sr, _ = tw.trace_lanes_ref(wa6, *crop_lanes)
    compare_states("atrium/auto", st, sr)
    k3_loop("atrium/suspend", wa6, crop_lanes, device,
            alpha_actions(wa6, r4.sa, crop_lanes, table6), rounds=3)
    print(f"  textured atrium TLAS ({wa6.nodes.shape[0]} nodes, depth "
          f"{wa6.depth}): {crop_lanes[0].shape[0]} rays, mean steps "
          f"{float(st.nodes_visited.float().mean()):.3f} (max "
          f"{int(st.nodes_visited.max())}); auto-accept and 3 suspension "
          f"rounds equal the plain version's")

    # timed: the first suspension round of the parity frame's primary wave,
    # in place as the pool path runs it: the profiler's kernel time with
    # the state put back before each launch (copies it keeps apart); CUDA
    # events around launches on fresh states made beforehand beside it
    cuda = device.type == "cuda"
    lanes = pool_lanes(cam6, parity, parity, 2, device)
    fresh = tw.init_state_lanes(*lanes)
    st_w, work = tw.lanes_work(wa6, *lanes, state=fresh, suspend=True)
    reps = 10
    states = [tw.WideState(*(a.clone() for a in fresh))
              for _ in range(reps + 1)]
    calls = [tw.kernel_call(wa6, *lanes, state=s, suspend=True) if cuda
             else (lambda s=s: tw.walk_lanes(wa6, *lanes, state=s,
                                             suspend=True))
             for s in states]
    st_k = calls[0]()
    compare_states("atrium/parity round 0", st_k, st_w)

    def in_place():
        for a, f in zip(states[0], fresh):
            a.copy_(f)
        return calls[0]()

    events_ms = float("nan")
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for c in calls[1:]:
            c()
        end.record()
        end.synchronize()
        events_ms = start.elapsed_time(end) / reps
        for s in states[1:]:
            compare_states("atrium/parity round 0, fresh states", s, st_w)
    b = wb.k3_bound(work, fresh, st_w, suspend=True)
    b_all = wb.k3_bound(work)
    # (a CPU rehearsal has no device time).  K3's time is the profiler's
    # kernel time: the kernel (~35 us) is not much longer than its
    # launch's host work (43 state pointers), so CUDA events around the
    # launches read the host's pace; they stand beside it, and in its
    # place where the profiler recorded no launch
    ms = (_profiled_kernel_ms(in_place, 10, ["traverse_wide"])
          ["traverse_wide"] if cuda else float("nan"))
    ms_source = "profiler_kernel"
    if cuda and ms != ms:   # the profiler recorded no launch
        ms, ms_source = events_ms, "cuda_events_in_place"
    # the timed relaunches wrote the same state again
    compare_states("atrium/parity round 0, relaunched", in_place(), st_w)
    plain_ms = _elapsed_ms(lambda: tw.trace_lanes_ref(wa6, *lanes,
                                                      suspend=True), 1,
                           device)
    steps = st_k.nodes_visited.float()
    warp_max = steps.reshape(-1, 32).max(1).values.mean() \
        if steps.numel() % 32 == 0 else steps.max()
    # blocks of 128 an SM (the occupancy calculator, at the registers
    # ptxas gave the kernel)
    per_sm = (kernels.load("traverse_wide").lib
              .vrt_traverse_wide_blocks_per_sm() if cuda else None)
    print(f"  K3 first suspension round of the parity frame's primary wave "
          f"({lanes[0].shape[0]} lanes, {int(st_k.suspended.sum())} "
          f"suspended): {ms:.4f} ms in place ({ms_source}; CUDA events "
          f"around launches on fresh states {events_ms:.4f} ms), plain "
          f"{plain_ms:.4f} ms; "
          f"steps mean {float(steps.mean()):.3f} warp-max "
          f"{float(warp_max):.3f}; bound {b.ms:.4f} ms ({b.bound_by}: "
          f"{b.ops} ops, {b.bytes} B) = {b.ms / ms:.1%}; the first "
          f"version's figure (every lane's whole state) {b_all.ms:.4f} ms; "
          f"blocks of 128 an SM {per_sm}")
    return dict(max_abs_err=0.0, ms=ms, ms_source=ms_source,
                blocks_per_sm=per_sm,
                events_ms=events_ms, plain_ms=plain_ms, bound_ms=b.ms,
                bound_by=b.bound_by, bound_every_lane_ms=b_all.ms,
                lanes=lanes[0].shape[0],
                mean_steps=float(steps.mean()), cutout_rounds=rounds)


def phase_alpha_walks(device, r6, r6_tlas, cam6, c2, sc, size: int = 512
                      ) -> dict:
    """13b: K1's and K2's alpha modes against their plain versions on
    row 6's tables (512x512 camera rays, their shadow rays, a mixed wave),
    timed beside the walks without alpha and their bounds; K1's times
    without alpha at config 2 and the scale scene re-read."""
    import torch

    from vortex_rt_tpu_torch.ops import packet_walk as pw
    from vortex_rt_tpu_torch.ops import traverse_packet as tp
    from vortex_rt_tpu_torch.ops.traverse_wide import WideArrays
    from vortex_rt_tpu_torch.tools import k1_timing
    from vortex_rt_tpu_torch.tools import walk_bounds as wb
    from vortex_rt_tpu_torch.tools.bench_ladder import ALPHA6, LIGHT6
    from vortex_rt_tpu_torch.utils.config import LARGE_FLOAT

    o, d = camera_rays(cam6, size, size, device)
    n = o.shape[0]
    err = {"k1": 0.0, "k2": 0.0}
    for name, r, walk, ref in (
            ("k1", r6, tp.trace_packets, tp.trace_packets_ref),
            ("k2", r6_tlas, pw.trace_packets_walk,
             pw.trace_packets_walk_ref)):
        wa = r.wa
        base, _ = walk(wa, o, d, alpha_ref=ALPHA6)
        hit = base.dist < LARGE_FLOAT
        light = torch.tensor(LIGHT6, dtype=torch.float32, device=device)
        hp = o + d * base.dist.clamp_max(1e18).unsqueeze(1)
        sl = light - hp
        dist_l = torch.sqrt((sl * sl).sum(1) + 1e-20)
        sd = sl / dist_l.unsqueeze(1)
        so, clamp = hp + sd * 1e-3, dist_l * (1.0 - 1e-3)
        cases = [("closest", o, d, {}),
                 ("shadow", so, sd, dict(active=hit, t_max=clamp,
                                         occlusion=True))]
        if name == "k1":
            cases.append(("mixed", torch.cat([so, o]), torch.cat([sd, d]),
                          dict(active=torch.cat([hit, hit]),
                               t_max=torch.cat([clamp, torch.full_like(
                                   clamp, LARGE_FLOAT)]), occl_split=n)))
        for mode, co, cd, kw in cases:
            k, ks = walk(wa, co, cd, alpha_ref=ALPHA6, **kw)
            _sync(device)
            pp, ps = ref(wa, co, cd, alpha_ref=ALPHA6, **kw)
            err[name] = max(err[name], compare_hits(
                f"{name} alpha/{mode}", k, pp, ks, ps))
    # K1: a 1-in-31 crop of row 6's 1080p primary wave (66,891 rays)
    oh, dh = camera_rays(cam6, 1920, 1080, device)
    oh, dh = oh[::31].contiguous(), dh[::31].contiguous()
    k, ks = tp.trace_packets(r6.wa, oh, dh, alpha_ref=ALPHA6)
    _sync(device)
    pp, ps = tp.trace_packets_ref(r6.wa, oh, dh, alpha_ref=ALPHA6)
    err["k1"] = max(err["k1"], compare_hits(
        "k1 alpha/closest 1080p crop", k, pp, ks, ps))
    del oh, dh, k, ks, pp, ps
    # K1: the primary wave in alpha mode against the same rays over the
    # same scene's fused table without alpha fields (the walk without alpha)
    plain_wa = WideArrays.from_scene(r6.sb, width=8).fuse().to(device)
    if device.type != "cuda":  # (a CPU rehearsal has no device time)
        return {"traverse_packet_alpha": dict(max_abs_err=err["k1"]),
                "packet_walk_alpha": dict(max_abs_err=err["k2"])}
    k1a = k1_timing.time_wave(r6.wa, o, d, dict(alpha_ref=ALPHA6),
                              {"k1": tp.kernel_call}, 20)
    k1n = k1_timing.time_wave(plain_wa, o, d, {}, {"k1": tp.kernel_call}, 20)
    a_ms, n_ms = k1a["versions"]["k1"]["ms"], k1n["versions"]["k1"]["ms"]
    _, _, work = tp.walk_work(r6.wa, o, d, alpha_ref=ALPHA6)
    every = wb.k1_bound(work, lookups=False)
    print(f"  K1 primary wave {size}x{size}: alpha {a_ms:.4f} ms (steps mean "
          f"{k1a['mean_steps']:.3f}, {int(work.alpha_lookups.sum())} alpha "
          f"tests made of {int(work.alpha_tests.sum())} candidates, "
          f"bound {k1a['bound_ms']:.4f} ms ({k1a['bound_by']}; every "
          f"candidate tested {every.ms:.4f} ms) = "
          f"{k1a['bound_ms'] / a_ms:.1%}); without alpha {n_ms:.4f} ms (steps "
          f"mean {k1n['mean_steps']:.3f}): x{a_ms / n_ms:.3f}; fused rows "
          f"{r6.wa.fused.shape[1] * 4} B with alpha, "
          f"{plain_wa.fused.shape[1] * 4} B without")
    k1_plain_ms = _elapsed_ms(lambda: tp.trace_packets_ref(
        r6.wa, o, d, alpha_ref=ALPHA6), 1, device)
    # K2: the same rays over the TLAS build
    call = pw.kernel_call(r6_tlas.wa, o, d, alpha_ref=ALPHA6)
    call()
    k2_ms = _device_ms(call, 20)
    k2n_ms = _device_ms(pw.kernel_call(r6_tlas.wa, o, d), 20)
    _, k2_steps, k2_work = pw.walk_work_4(r6_tlas.wa, o, d,
                                          alpha_ref=ALPHA6)
    k2b = wb.k2_bound(k2_work)
    k2_plain_ms = _elapsed_ms(lambda: pw.trace_packets_walk_ref(
        r6_tlas.wa, o, d, alpha_ref=ALPHA6), 1, device)
    print(f"  K2 primary wave {size}x{size} (TLAS): alpha {k2_ms:.4f} ms (steps "
          f"mean {float(k2_steps.float().mean()):.3f}), without alpha "
          f"{k2n_ms:.4f} ms; bound {k2b.ms:.4f} ms ({k2b.bound_by}) = "
          f"{k2b.ms / k2_ms:.1%}; plain {k2_plain_ms:.4f} ms")
    prim = next(iter(sc.get("waves", {}).values()), {})
    print(f"  K1 without alpha, re-read: config 2 primary wave "
          f"{c2['ms']:.4f} ms, scale primary wave "
          f"{prim.get('ms', float('nan')):.4f} ms (PERF.md's kernel table "
          f"holds the earlier readings)")
    return {
        "traverse_packet_alpha": dict(
            max_abs_err=err["k1"], ms=a_ms, plain_ms=k1_plain_ms,
            bound_ms=k1a["bound_ms"], bound_by=k1a["bound_by"],
            no_alpha_ms=n_ms, bound_every_ms=every.ms,
            alpha_tests=int(work.alpha_tests.sum()),
            alpha_lookups=int(work.alpha_lookups.sum())),
        "packet_walk_alpha": dict(
            max_abs_err=err["k2"], ms=k2_ms, plain_ms=k2_plain_ms,
            bound_ms=k2b.ms, bound_by=k2b.bound_by, no_alpha_ms=k2n_ms)}


def phase_row6(device, target_tris: int = 260_000, n_cols: int = 12,
               res=(512, 512), res_hd=(1920, 1080)) -> tuple:
    """13c: ladder row 6 through the tool's entry points, launch counts
    reset before and read after: the 512x512 and 1080p frames through K1's
    alpha mode (no K3); then a 512x512 frame of the same scene on the
    4-wide TLAS build through K2's alpha mode."""
    import numpy as np
    import torch

    from vortex_rt_tpu_torch import RTConfig, WavefrontRenderer
    from vortex_rt_tpu_torch.runtime import kernels
    from vortex_rt_tpu_torch.tools import bench_ladder

    t0 = time.perf_counter()
    sc6, r, cam, p, table = bench_ladder.setup6(device, target_tris, n_cols)
    build_s = time.perf_counter() - t0
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    rec = bench_ladder.frames6(r, cam, p, res, res_hd)
    _sync(device)
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    frames = 6  # a warm-up and two timed frames at each size
    _check(not cuda or launches["traverse_packet_alpha"] == 8 * frames,
           f"row 6 launched K1's alpha mode {launches['traverse_packet_alpha']}"
           f" times for {frames} frames (4 waves a pass, spp 2)")
    _check(launches["traverse_wide"] == 0 and launches["traverse_packet"] == 0
           and launches["packet_walk_alpha"] == 0,
           f"row 6's frames launched other walks: {launches}")
    w, h = res
    img, rays = r.render(cam, p, w, h)
    _check(img.shape == (h, w, 3) and np.isfinite(img).all()
           and rays >= w * h * p.spp, "row 6 image is not finite")
    rec.update(peak_bytes=int(peak), build_s=build_s,
               k1_alpha_launches=launches["traverse_packet_alpha"],
               k1_alpha_launches_per_frame=launches["traverse_packet_alpha"]
               // frames)
    print(f"  row 6: {json.dumps(rec)}")
    # the 4-wide TLAS route of the same scene and shader (K2 alpha)
    cfg4 = RTConfig()
    r4 = WavefrontRenderer.from_buffers(sc6.build(cfg4), cfg4, table,
                                        device=device)
    r4.render(cam, p, 64, 64)  # warm-up
    kernels.reset_launches()
    t0 = time.perf_counter()
    img4, rays4 = r4.render(cam, p, w, h)
    ms4 = (time.perf_counter() - t0) * 1e3
    launches4 = dict(kernels.LAUNCHES)
    _check(not cuda or (launches4["packet_walk_alpha"] == 8
                        and launches4["traverse_wide"] == 0),
           f"the 4-wide alpha frame launched {launches4}")
    _check(rays4 == rays and np.isfinite(img4).all(),
           f"the 4-wide row-6 frame traced {rays4} rays, the 8-wide {rays}")
    # (two trees of one scene: an exact-t tie may resolve differently)
    off = int((np.abs(img4 - img).max(-1) > IMG_ATOL).sum())
    print(f"  4-wide TLAS route (K2 alpha): {ms4:.3f} ms a {w}x{h} frame, "
          f"{rays4} rays (8-wide {rays}), K2 alpha launches "
          f"{launches4['packet_walk_alpha']}, {off} pixels differ from the "
          f"8-wide frame by more than {IMG_ATOL}")
    rec.update(k2_alpha_launches=launches4["packet_walk_alpha"],
               tlas_frame_ms=ms4)
    return rec, sc6, r, r4, cam, p, table


def phase_parity6(device, sc6, r, cam, p, table, size: int = 192) -> dict:
    """13d: row 6's gate, the 192x192 frame against the suspension engine
    (K3 on the TLAS build), launch counts reset before."""
    from vortex_rt_tpu_torch.runtime import kernels
    from vortex_rt_tpu_torch.tools import bench_ladder

    kernels.reset_launches()
    rec = bench_ladder.parity6(sc6, r, cam, p, table, size)
    _sync(device)
    launches = dict(kernels.LAUNCHES)
    _check(device.type != "cuda"
           or launches["traverse_wide"] == rec["k3_launches"] > 0,
           f"the suspension frame launched K3 {launches['traverse_wide']} "
           f"times")
    _check(rec["parity_ok"], f"row 6 parity failed: {json.dumps(rec)}")
    print(f"  row 6 parity: {json.dumps(rec)}")
    return dict(rec, launches=launches["traverse_wide"])


def phase_chunked(device, r_tlas, cam, p, size: int = 128) -> dict:
    """13d: ``render(mode="chunked")``, the JAX host-orchestrated frame,
    on row 6's TLAS build with the default shaders and no shadows: the
    compacted pool traced by K3 (launch counts reset before), against the
    same frame traced by the plain walk.  Images within 1e-5, equal ray
    counts."""
    import numpy as np

    from vortex_rt_tpu_torch.engine import wavefront as wf
    from vortex_rt_tpu_torch.engine.shaders import ShaderTable
    from vortex_rt_tpu_torch.ops import traverse_wide as tw
    from vortex_rt_tpu_torch.runtime import kernels

    r = dataclasses.replace(r_tlas, table=ShaderTable())
    p = dataclasses.replace(p, shadow=False)
    kernels.reset_launches()
    img, rays = r.render(cam, p, size, size, mode="chunked")
    _sync(device)
    launches = kernels.LAUNCHES["traverse_wide"]
    real = wf.walk_lanes
    wf.walk_lanes = (lambda *a, **kw: tw.trace_lanes_ref(*a, **kw)[1])
    try:
        img_p, rays_p = r.render(cam, p, size, size, mode="chunked")
    finally:
        wf.walk_lanes = real
    err = float(np.abs(img - img_p).max())
    _check(img.shape == (size, size, 3) and np.isfinite(img).all(),
           "the chunked frame is not a finite image")
    _check(device.type != "cuda" or launches > 0,
           "the chunked frame launched no K3")
    _check(rays == rays_p and err <= 1e-5,
           f"chunked frame: rays {rays} vs plain {rays_p}, max abs err "
           f"{err}")
    print(f"  chunked frame {size}x{size} spp {p.spp} depth {p.max_depth}: "
          f"{rays} rays, {launches} K3 launches, max abs err {err} against "
          f"the plain walk's frame")
    return dict(rays=rays, launches=launches, max_abs_err=err)


# ------------------------------ stateless any-hit predicates (19a-19e)

PRED_TOL = 2e-6   # the parity frame's bound (tests/test_anyhit_inline.py)


def _same_hits(label: str, got, want, steps_got, steps_want) -> None:
    """Every hit field and per-ray step of a kernel equal to the plain
    version's, to the bit."""
    import torch

    for name, a, b in zip(("dist", "bx", "by", "bz", "tri", "inst",
                           "steps"), (*got, steps_got), (*want, steps_want)):
        _check(torch.equal(a, b), f"{label}: {name} differs from the plain "
               f"version")
    print(f"  {label}: rays {got.dist.numel()}, hits or occluded "
          f"{int((got.dist < 1e30).sum())}: every field and step equal")


def phase_pred_build(device, name: str = "checker_pred") -> dict:
    """19a (19e): the predicate ``bench_ladder.<name>`` compiled and K1's
    and K2's variants built; the predicate entries' ptxas lines."""
    from concurrent.futures import ThreadPoolExecutor

    from vortex_rt_tpu_torch.ops.anyhit_pred import compile_predicate
    from vortex_rt_tpu_torch.runtime import kernels
    from vortex_rt_tpu_torch.tools import bench_ladder
    from vortex_rt_tpu_torch.tools import walk_bounds as wb
    from vortex_rt_tpu_torch.tools.walk_timing import _ptxas_entries

    pred = compile_predicate(getattr(bench_ladder, name))
    print(f"  {name}: header {pred.header_name} ({pred.n_ops} operations, "
          f"{wb.pred_ops(pred)} weighted: {', '.join(pred.ops)})")
    names = ("traverse_packet", "packet_walk")
    with ThreadPoolExecutor(max_workers=2) as pool:
        futures = {n: pool.submit(kernels.load_pred, n, pred) for n in names}
        libs = {n: f.result() for n, f in futures.items()}
    rebuilt, ptxas = {}, {}
    for n, lib in libs.items():
        # (the predicate mode is the kernels' template mode 2)
        ptxas[n] = {e.split(">")[0] + ">": line for e, line in
                    _ptxas_entries(lib.build_log).items() if "<2," in e}
        print(f"  {lib.path.name}: nvcc {lib.build_seconds:.2f} s at first "
              f"use; ptxas of the predicate entries: " + "; ".join(
                  f"{e}: {line}" for e, line in ptxas[n].items()))
        # a second use: the process's library, and without it the build
        # on disk (no nvcc)
        _check(kernels.load_pred(n, pred) is lib,
               f"{n}: a second load_pred loaded again")
        kernels._loaded.pop(f"{n}+pred-{pred.digest}")
        again = kernels.load_pred(n, pred)
        rebuilt[n] = again.build_seconds
        _check(again.build_seconds == 0.0 and again.path == lib.path,
               f"{n}: the predicate variant was built twice")
    print(f"  second use: nvcc seconds {rebuilt} (0: the builds were reused)")
    return dict(pred=pred, digest=pred.digest, n_ops=pred.n_ops,
                pred_ops=wb.pred_ops(pred), ptxas=ptxas,
                build_s={n: lib.build_seconds for n, lib in libs.items()})


def phase_pred_walks(device, r_flat, r_tlas, plain_wa, cam6, pred,
                     size: int = 512, reps: int = 20, crop: int = 31
                     ) -> dict:
    """19b: K1's and K2's predicate modes against their plain versions (to
    the bit) on a crop of row 6's 1080p waves through the wrappers, then on
    each whole 512x512 wave through the bare launch it times (in predicate
    mode with its slot classes and with every slot forced to ``CLS_TEST``,
    the parent's tests, in alpha mode and without any-hit, beside the
    bound of the tests the classes leave and of every candidate's), with
    the candidates' shares by slot class."""
    import torch

    from vortex_rt_tpu_torch.ops import packet_walk as pw
    from vortex_rt_tpu_torch.ops import traverse_packet as tp
    from vortex_rt_tpu_torch.tools import walk_bounds as wb
    from vortex_rt_tpu_torch.tools.bench_ladder import ALPHA6, LIGHT6
    from vortex_rt_tpu_torch.utils.config import LARGE_FLOAT

    def waves(wa, walk, o, d, mixed: bool):
        """(mode, o, d, kwargs): camera rays, the shadow rays from their
        predicate-mode hits, and (``mixed``) both in one occl_split wave."""
        base, _ = walk(wa, o, d, anyhit_pred=pred)
        hit = base.dist < LARGE_FLOAT
        light = torch.tensor(LIGHT6, dtype=torch.float32, device=device)
        hp = o + d * base.dist.clamp_max(1e18).unsqueeze(1)
        sl = light - hp
        dist_l = torch.sqrt((sl * sl).sum(1) + 1e-20)
        sd = sl / dist_l.unsqueeze(1)
        so, clamp = hp + sd * 1e-3, dist_l * (1.0 - 1e-3)
        out = [("primary", o, d, {}),
               ("shadow", so, sd, dict(active=hit, t_max=clamp,
                                       occlusion=True))]
        if mixed:
            out.append(("mixed", torch.cat([so, o]), torch.cat([sd, d]),
                        dict(active=torch.cat([hit, torch.ones_like(hit)]),
                             t_max=torch.cat([clamp, torch.full_like(
                                 clamp, LARGE_FLOAT)]),
                             occl_split=o.shape[0])))
        return out

    oh, dh = camera_rays(cam6, 1920, 1080, device)
    oh, dh = oh[::crop].contiguous(), dh[::crop].contiguous()
    o, d = camera_rays(cam6, size, size, device)
    rec = {}
    for name, r, walk, ref, work_fn, mod in (
            ("traverse_packet_pred", r_flat, tp.trace_packets,
             tp.trace_packets_ref, tp.walk_work, tp),
            ("packet_walk_pred", r_tlas, pw.trace_packets_walk,
             pw.trace_packets_walk_ref, pw.walk_work_4, pw)):
        k1 = mod is tp
        t0 = time.perf_counter()
        classes = mod.pred_classes(r.wa, pred)
        class_s = time.perf_counter() - t0
        all_test = classes._replace(cls=torch.zeros_like(classes.cls))
        print(f"  {name}: slot classes {classes.counts}, representative "
              f"alpha {classes.rep:.6g}, ops without a rule "
              f"{list(classes.no_rule)}; made in {class_s:.2f} s on the host")
        for mode, co, cd, kw in waves(r.wa, walk, oh, dh, k1):
            k, ks = walk(r.wa, co, cd, anyhit_pred=pred, **kw)
            _sync(device)
            pp, ps = ref(r.wa, co, cd, anyhit_pred=pred, **kw)
            _same_hits(f"{name} {mode} (1080p crop)", k, pp, ks, ps)
        if device.type != "cuda":  # (a CPU rehearsal has no device time)
            rec[name] = dict(max_abs_err=0.0)
            continue
        none_wa = plain_wa if k1 else r.wa
        out, got = {}, {}
        for mode, co, cd, kw in waves(r.wa, walk, o, d, k1):
            calls = {
                "pred": mod.kernel_call(r.wa, co, cd, anyhit_pred=pred, **kw),
                "all_test": mod.kernel_call(r.wa, co, cd, anyhit_pred=pred,
                                            pred_cls=all_test, **kw),
                "alpha": mod.kernel_call(r.wa, co, cd, alpha_ref=ALPHA6,
                                         **kw),
                "none": mod.kernel_call(none_wa, co, cd, **kw)}
            got[mode] = calls["pred"]()
            every = calls["all_test"]()
            _sync(device)
            # the plain walk of the whole wave, counting its work
            want, steps, work = work_fn(r.wa, co, cd, anyhit_pred=pred, **kw)
            _same_hits(f"{name} {mode} {size}x{size}", got[mode][0], want,
                       got[mode][1], steps)
            _same_hits(f"{name} {mode} {size}x{size}, every slot tested",
                       every[0], want, every[1], steps)
            del want, every
            ms = {n: [] for n in calls}
            for n in [*calls, *reversed(list(calls))]:  # in turns
                ms[n].append(_device_ms(calls[n], reps))
            ms = {n: sum(v) / len(v) for n, v in ms.items()}
            p_ops = wb.pred_ops(pred)
            b, b0 = ((wb.k1_bound if k1 else wb.k2_bound)(
                work, lookups=lk, pred_ops=p_ops) for lk in (True, False))
            cand = int(work.alpha_tests.sum())
            share = {c: n / max(cand, 1) for c, n in zip(
                ("test", "kept", "cut", "uv"), work.by_class.tolist())}
            out[mode] = dict(ms=ms["pred"], all_test_ms=ms["all_test"],
                             alpha_ms=ms["alpha"], no_anyhit_ms=ms["none"],
                             bound_ms=b.ms, bound_by=b.bound_by,
                             bound_every_ms=b0.ms, pred_tests=cand,
                             tests_made=int(work.alpha_lookups.sum()),
                             texel_reads=int(work.texel_reads.sum()),
                             class_share=share,
                             mean_steps=float(steps.float().mean()))
            print(f"  {name} {mode} {size}x{size} ({co.shape[0]} rays): "
                  f"predicate {ms['pred']:.4f} ms, every slot tested "
                  f"{ms['all_test']:.4f} ms, alpha {ms['alpha']:.4f} ms, "
                  f"without any-hit {ms['none']:.4f} ms (events, mean of "
                  f"{reps} launches, in turns); bound {b.ms:.4f} ms "
                  f"({b.bound_by}) = {b.ms / ms['pred']:.1%} (every "
                  f"candidate tested: {b0.ms:.4f} ms); {cand} candidates, "
                  f"by class " + ", ".join(f"{c} {v:.1%}" for c, v in
                                           share.items())
                  + f"; {out[mode]['tests_made']} tests, "
                  f"{out[mode]['texel_reads']} texel reads; steps mean "
                  f"{out[mode]['mean_steps']:.3f}")
        _sync(device)
        t0 = time.perf_counter()
        want, steps = ref(r.wa, o, d, anyhit_pred=pred)
        _sync(device)
        plain_ms = (time.perf_counter() - t0) * 1e3
        _same_hits(f"{name} primary {size}x{size} (the plain version)",
                   got["primary"][0], want, got["primary"][1], steps)
        del got, want, steps
        prim = out["primary"]
        rec[name] = dict(max_abs_err=0.0, ms=prim["ms"], plain_ms=plain_ms,
                         bound_ms=prim["bound_ms"], bound_by=prim["bound_by"],
                         bound_every_ms=prim["bound_every_ms"],
                         all_test_ms=prim["all_test_ms"],
                         alpha_ms=prim["alpha_ms"],
                         no_anyhit_ms=prim["no_anyhit_ms"],
                         pred_tests=prim["pred_tests"],
                         class_share=prim["class_share"],
                         slot_classes=classes.counts, class_build_s=class_s,
                         other_waves={k: v for k, v in out.items()
                                      if k != "primary"})
        print(f"  {name}: the plain walk's primary wave {plain_ms:.2f} ms")
    return rec


def phase_pred_frames(device, r_flat, r_tlas, r_pool, cam, p,
                      res=(512, 512), res_hd=(1920, 1080),
                      label: str = "checker") -> dict:
    """19c: row 6's scene with the checker predicate through K1's
    predicate mode (512x512 and 1080p) and K2's (the TLAS build), launch
    counts reset before and read after each: ms a frame, rays, launches,
    no K3.  The 512x512 frames of both against the suspension engine's
    (``r_pool``: K3 running the shader's callable), the 1080p frame of K1
    against K2's: equal rays, images within ``PRED_TOL``."""
    import numpy as np

    from vortex_rt_tpu_torch.runtime import kernels
    from vortex_rt_tpu_torch.tools import bench_ladder

    def err(a, b) -> float:
        return float(np.abs(a - b).max())

    cuda = device.type == "cuda"
    frames = 6  # bench_frames: a warm-up and two timed frames a size
    kernels.reset_launches()
    rec = dict(bench_ladder.bench_frames(r_flat, cam, p, *res))
    hd = bench_ladder.bench_frames(r_flat, cam, p, *res_hd)
    _sync(device)
    k1 = dict(kernels.LAUNCHES)
    _check(not cuda or k1["traverse_packet_pred"] == 8 * frames,
           f"row 6 with the predicate launched K1's predicate mode "
           f"{k1['traverse_packet_pred']} times for {frames} frames")
    _check(k1["traverse_wide"] == 0 and k1["traverse_packet"] == 0
           and k1["traverse_packet_alpha"] == 0,
           f"the predicate frames launched other walks: {k1}")
    w, h = res
    img, rays = r_flat.render(cam, p, w, h)
    _check(img.shape == (h, w, 3) and np.isfinite(img).all()
           and rays >= w * h * p.spp, "the predicate frame is not finite")
    img_s, rays_s = r_pool.render(cam, p, w, h)
    err_s = err(img, img_s)
    _check(rays == rays_s and err_s <= PRED_TOL,
           f"the {w}x{h} predicate frame through K1: {rays} rays, the "
           f"suspension engine's {rays_s}; max abs err {err_s}")
    r_tlas.render(cam, p, 64, 64)  # warm-up
    kernels.reset_launches()
    t0 = time.perf_counter()
    img4, rays4 = r_tlas.render(cam, p, w, h)
    ms4 = (time.perf_counter() - t0) * 1e3
    k2 = dict(kernels.LAUNCHES)
    _check(not cuda or (k2["packet_walk_pred"] == 8
                        and k2["traverse_wide"] == 0
                        and k2["traverse_packet_pred"] == 0),
           f"the 4-wide predicate frame launched {k2}")
    err4 = err(img4, img_s)
    off = int((np.abs(img4 - img).max(-1) > IMG_ATOL).sum())
    _check(rays4 == rays and np.isfinite(img4).all() and err4 <= PRED_TOL
           and off == 0,
           f"the 4-wide predicate frame traced {rays4} rays (8-wide {rays}),"
           f" max abs err {err4} against the suspension engine's, {off} "
           f"pixels off the 8-wide frame")
    img_hd, rays_hd = r_flat.render(cam, p, *res_hd)
    img4_hd, rays4_hd = r_tlas.render(cam, p, *res_hd)
    err_hd = err(img_hd, img4_hd)
    _check(rays_hd == rays4_hd and np.isfinite(img_hd).all()
           and np.isfinite(img4_hd).all() and err_hd <= PRED_TOL,
           f"the 1080p predicate frames: K1 {rays_hd} rays, K2 {rays4_hd}; "
           f"max abs err {err_hd}")
    rec.update(res_hd=f"{res_hd[0]}x{res_hd[1]}",
               rays_per_frame_hd=hd["rays_per_frame"], mrays_hd=hd["mrays"],
               ms_per_frame_hd=hd["ms_per_frame"],
               k1_pred_launches=k1["traverse_packet_pred"],
               k1_pred_launches_per_frame=k1["traverse_packet_pred"]
               // frames, k2_pred_launches=k2["packet_walk_pred"],
               k3_launches=k1["traverse_wide"] + k2["traverse_wide"],
               tlas_frame_ms=ms4, tlas_pixels_off=off,
               max_abs_err_vs_suspension=err_s,
               tlas_max_abs_err_vs_suspension=err4,
               hd_max_abs_err_k1_vs_k2=err_hd)
    print(f"  row 6 + {label} predicate, K1: {rec['ms_per_frame']:.3f} ms a "
          f"{w}x{h} frame ({rec['rays_per_frame']} rays, "
          f"{rec['mrays']:.3f} Mrays/s), {rec['ms_per_frame_hd']:.3f} ms at "
          f"1080p ({rec['rays_per_frame_hd']} rays, {rec['mrays_hd']:.3f} "
          f"Mrays/s); traverse_packet_pred launches {k1['traverse_packet_pred']}"
          f" for {frames} frames; K3 launches 0")
    print(f"  {w}x{h} against the suspension engine (TLAS, packet_size=0): "
          f"{rays} rays each, max abs err {err_s}")
    print(f"  4-wide TLAS (K2): {ms4:.3f} ms a {w}x{h} frame, {rays4} rays; "
          f"packet_walk_pred launches {k2['packet_walk_pred']}; max abs err "
          f"{err4} against the suspension engine; {off} pixels differ from "
          f"the 8-wide frame by more than {IMG_ATOL}")
    print(f"  1080p: K1's frame against K2's, {rays_hd} rays each, max abs "
          f"err {err_hd}")
    return rec


def phase_pred_parity(device, sc6, r_flat, cam, p, table, size: int = 192
                      ) -> dict:
    """19d: the parity frame against the suspension engine (K3 running the
    shader's callable), launch counts reset before."""
    from vortex_rt_tpu_torch.runtime import kernels
    from vortex_rt_tpu_torch.tools import bench_ladder

    kernels.reset_launches()
    rec = bench_ladder.parity6(sc6, r_flat, cam, p, table, size)
    _sync(device)
    launches = dict(kernels.LAUNCHES)
    _check(device.type != "cuda"
           or (launches["traverse_wide"] == rec["k3_launches"] > 0
               and launches["traverse_packet_pred"] > 0),
           f"the parity frames launched {launches}")
    _check(rec["rays_parity"] == rec["rays_suspension"]
           and rec["parity_max_abs"] <= PRED_TOL,
           f"the predicate's parity frame: {json.dumps(rec)}")
    print(f"  parity {size}x{size}: {json.dumps(rec)}")
    return dict(rec, k1_launches=launches["traverse_packet_pred"])


def phase_pred(device, sc6, sb6, sb6_tlas, cam6, p6) -> dict:
    """19a-19e on row 6's scene, from its host builds (13c's)."""
    import torch

    from vortex_rt_tpu_torch import RTConfig, WavefrontRenderer
    from vortex_rt_tpu_torch.engine.shaders import (
        ShaderTable, stateless_anyhit,
    )
    from vortex_rt_tpu_torch.ops.traverse_wide import WideArrays
    from vortex_rt_tpu_torch.tools import bench_ladder

    _phase("phase 19a the checker predicate compiled into K1 and K2")
    built = phase_pred_build(device)
    pred = built["pred"]
    table = ShaderTable(anyhit=stateless_anyhit(bench_ladder.checker_pred,
                                                "checker"))
    r_flat = WavefrontRenderer.from_buffers(sb6, RTConfig(flatten=True),
                                            table, device=device)
    r_tlas = WavefrontRenderer.from_buffers(sb6_tlas, RTConfig(), table,
                                            device=device)
    r_pool = WavefrontRenderer.from_buffers(
        sb6_tlas, RTConfig(packet_size=0), table, device=device)
    plain_wa = WideArrays.from_scene(sb6, width=8).fuse().to(device)
    _phase("phase 19b K1's and K2's predicate modes vs their plain versions "
           "(row 6's waves)")
    walks = phase_pred_walks(device, r_flat, r_tlas, plain_wa, cam6, pred)
    del plain_wa
    torch.cuda.empty_cache()
    _phase("phase 19c row 6 with the checker predicate: 512x512 and 1080p "
           "through K1, the 4-wide TLAS frame through K2")
    frames = phase_pred_frames(device, r_flat, r_tlas, r_pool, cam6, p6)
    _phase("phase 19d the predicate's parity frame against the suspension "
           "engine (K3)")
    parity = phase_pred_parity(device, sc6, r_flat, cam6, p6, table)
    _phase("phase 19e the perforated predicate (sqrt, sin, cos and ** "
           "correctly rounded) in K1 and K2 on row 6's scene")
    perf = phase_pred_perforated(device, r_flat, r_tlas, r_pool, sb6, cam6,
                                 p6, walks)
    return dict(build=built, walks=walks, frames=frames, parity=parity,
                perforated=perf)


def phase_pred_perforated(device, r_flat, r_tlas, r_pool, sb6, cam6, p6,
                          checker: dict, crop: int = 61) -> dict:
    """19e: ``bench_ladder.perforated_pred`` through 19b's and 19c's
    checks and timings on 19's renderers with its table: K1's and K2's
    variants built (nvcc seconds, the predicate entries' ptxas lines),
    every timed 512x512 wave held to the plain walk of the same wave
    (hits and per-ray steps to the bit), the 512x512 frames to the
    suspension engine's and K1's 1080p frame to K2's (equal rays, within
    ``PRED_TOL``), launch counts; the waves' times beside the checker
    predicate's (``checker``: 19b's) and the alpha mode's."""
    import torch

    from vortex_rt_tpu_torch.engine.shaders import (
        ShaderTable, stateless_anyhit,
    )
    from vortex_rt_tpu_torch.ops.traverse_wide import WideArrays
    from vortex_rt_tpu_torch.tools import bench_ladder

    t0 = time.perf_counter()
    built = phase_pred_build(device, "perforated_pred")
    table = ShaderTable(anyhit=stateless_anyhit(bench_ladder.perforated_pred,
                                                "perforated"))
    r_flat, r_tlas, r_pool = (dataclasses.replace(r, table=table)
                              for r in (r_flat, r_tlas, r_pool))
    plain_wa = WideArrays.from_scene(sb6, width=8).fuse().to(device)
    walks = phase_pred_walks(device, r_flat, r_tlas, plain_wa, cam6,
                             built["pred"], crop=crop)
    del plain_wa
    torch.cuda.empty_cache()
    frames = phase_pred_frames(device, r_flat, r_tlas, r_pool, cam6, p6,
                               label="perforated")
    for name, rec in walks.items():
        if "ms" not in rec:
            continue
        waves = {"primary": rec, **rec["other_waves"]}
        ref = {"primary": checker[name], **checker[name]["other_waves"]}
        for mode, w in waves.items():
            print(f"  {name} {mode} 512x512: perforated {w['ms']:.4f} ms "
                  f"(every slot tested {w['all_test_ms']:.4f}), "
                  f"checker {ref[mode]['ms']:.4f} ms, alpha "
                  f"{w['alpha_ms']:.4f} ms, without any-hit "
                  f"{w['no_anyhit_ms']:.4f} ms; bound {w['bound_ms']:.4f} "
                  f"ms ({w['bound_by']}, {built['pred_ops']} operations a "
                  f"test) = {w['bound_ms'] / w['ms']:.1%}")
    seconds = time.perf_counter() - t0
    print(f"  phase 19e: {seconds:.1f} s")
    return dict(build={k: v for k, v in built.items() if k != "pred"},
                walks=walks, frames=frames, seconds=seconds)


# ------------------------------------- the sweep-SAH tree (12d, 12e)

SAH_KERNEL_NAMES = ("sweep_kernel",)


def sah_phase(device, label: str, verts, width: int, leaf: int, trees: dict,
              o, d, reps: int = 5, **walk_kw) -> dict:
    """The sweep-SAH build over ``verts`` (Morton-sorted leaves, the
    tree's one cooperative launch, the LBVH collapse, refit and pack;
    launch counts reset before one build and read after): build ms,
    levels, the real wide depth; the tree's kernel against
    ``_sah_sweep_tree_ref`` on the same leaf boxes (run on the card: torch
    ops), word for word, its live counts a level too; one launch and one
    read to the host a sweep (the profiler's device-to-host copies); the
    kernel's device time (profiler) and the whole sweep's by CUDA events
    beside its bound (the live positions of each level, and every
    position's, the earlier figure) and the plain version's; then K1
    over the sweep-SAH tree and ``trees`` (name -> WideArrays, the first
    the reference) on the rays ``o, d``: hits equal to the bit, steps per
    ray."""
    import statistics

    from vortex_rt_tpu_torch.accel import lbvh
    from vortex_rt_tpu_torch.runtime import kernels
    from vortex_rt_tpu_torch.tools import bench_ladder
    from vortex_rt_tpu_torch.tools import walk_bounds as wb

    cuda = device.type == "cuda"
    l = verts[0].shape[0]
    kernels.reset_launches()
    lb, topo = lbvh.build_lbvh_topo(*verts, leaf_size=leaf, method="sah",
                                    width=width)
    _sync(device)
    launches = dict(kernels.LAUNCHES)
    if cuda:
        # box + codes (no Karras), the sweep, the collapse with the refit
        # plan, the refit over it
        _check(launches["lbvh_sah"] == 1 and launches["lbvh_karras"] == 1
               and launches["lbvh_collapse"] == 1
               and launches["lbvh_refit"] == 1,
               f"{label}: the sweep-SAH build launched {launches}")
    build_ms = statistics.median(bench_ladder.timed_ms(
        lambda: lbvh.build_lbvh_topo(*verts, leaf_size=leaf, method="sah",
                                     width=width), device, reps))
    wa = lbvh.wide_arrays_from_lbvh(lb, leaf, width=width)
    lmin, lmax = lbvh._leaf_boxes(*verts, topo.order)
    live_k, live = [], []
    got = lbvh._sah_sweep_tree(lmin, lmax, l, live=live_k)
    levels = got[-1]
    want = lbvh._sah_sweep_tree_ref(lmin, lmax, l, live=live)
    _check(levels == want[-1], f"{label}: {levels} levels, the plain "
           f"version {want[-1]}")
    _check(live_k == live, f"{label}: the kernel's live counts a level "
           f"differ from the plain version's")
    err = _same_bits(f"{label}: sweep-SAH tree vs plain", got[:4], want[:4])
    # K5 C on this tree, whose node ids are not in their ranges
    _same_bits(f"{label}: refit boxes vs plain", lbvh._refit_boxes(
        topo, *verts), lbvh._refit_boxes_ref(topo, *verts))
    plan_vs_plain(label, topo, lbvh.topo_state(topo))
    _same_bits(f"{label}: the build's children vs the sweep's",
               (topo.lchild, topo.rchild, topo.lo, topo.hi), got[:4])
    sweep = lambda: lbvh._sah_sweep_tree(lmin, lmax, l)  # noqa: E731
    plain_ms = _elapsed_ms(lambda: lbvh._sah_sweep_tree_ref(lmin, lmax, l),
                           1, device)
    bound = wb.sah_bounds(l, levels, live)
    rec = dict(tris=l, levels=levels, build_ms=build_ms,
               launches=launches["lbvh_sah"],
               wide_depth=int(lb.wide_depth), walk_depth=wa.depth,
               max_abs_err=err, plain_ms=plain_ms, bound_ms=bound.ms,
               bound_by=bound.bound_by, live_positions=sum(live),
               bound_every_position_ms=wb.sah_bounds(l, levels).ms)
    if cuda:
        rec["ms"] = _device_ms(sweep, reps)
        # a sweep's launches (the wrapper's count) and reads to the host
        # (PyTorch's warnings on synchronising operations)
        n0 = kernels.LAUNCHES["lbvh_sah"]
        rec["host_reads"] = _host_syncs(sweep)
        rec["kernel_launches"] = kernels.LAUNCHES["lbvh_sah"] - n0
        _check(rec["host_reads"] == 1 and rec["kernel_launches"] == 1,
               f"{label}: a sweep made {rec['host_reads']} reads to the "
               f"host and {rec['kernel_launches']} launches")
        # the kernel's time a launch by the profiler (a session late in
        # the run may record part of the launches: the mean of those it
        # did), and the device operations it recorded a sweep
        ev = _kernel_events(lambda: [sweep() for _ in range(reps)])
        kern = [e for e in ev if "sweep_kernel" in e.key]
        n = sum(e.count for e in kern)
        rec["kernel_ms"] = {"sweep_kernel": sum(
            e.self_device_time_total for e in kern) / 1e3 / n
            if n else float("nan")}
        rec["profiled_sweeps"] = f"{n} of {reps}"
        rec["device_ops"] = (sum(e.count for e in ev) / n if n
                             else float("nan"))
    else:
        rec["ms"] = _elapsed_ms(sweep, 1, device)
    print(f"  {label}: T {l}, {width}-wide, leaf {leaf}: sweep-SAH build "
          f"{build_ms:.4f} ms (median of {reps}, CUDA events: Morton "
          f"codes and sort, {levels} levels of the sweep, the LBVH "
          f"collapse, refit and pack), {rec['launches']} lbvh_sah launch "
          f"and {rec.get('host_reads')} read to the host a sweep "
          f"({rec.get('device_ops')} device operations a sweep the profiler "
          f"recorded, {rec.get('profiled_sweeps')} sweeps), wide depth "
          f"{rec['wide_depth']} (walk stack for {wa.depth}); the sweep's "
          f"kernels equal the plain version word for word; the sweep "
          f"{rec['ms']:.4f} ms (CUDA events) against its bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}; "
          f"{rec['live_positions']} live positions over the levels; every "
          f"position at every level {rec['bound_every_position_ms']:.4f} "
          f"ms), plain {plain_ms:.4f} ms"
          + ("; the kernel (profiler, per sweep): " + ", ".join(
              f"{k} {v:.4f} ms" for k, v in rec["kernel_ms"].items())
             if cuda else ""))
    rec["steps"] = three_tree_steps(
        f"{label} rays", {**trees, "sah_sweep": wa}, o, d,
        next(iter(trees)), **walk_kw)
    return rec


def phase_sah_config3(device, reps: int = 5, blob_n: int = 187,
                      res=(1920, 1080)) -> dict:
    """Phase 12d: the sweep-SAH tree at config 3's mesh (blob n=187,
    69,940 triangles, 8-wide, leaf 4), K1 on config 3's 1080p camera
    rays over the host SAH, sweep-SAH, Karras and PLOC trees."""
    from vortex_rt_tpu_torch.accel import lbvh, ploc
    from vortex_rt_tpu_torch.engine.wavefront import WavefrontRenderer
    from vortex_rt_tpu_torch.models import bigscenes
    from vortex_rt_tpu_torch.models.scene import Scene
    from vortex_rt_tpu_torch.tools import bench_ladder
    from vortex_rt_tpu_torch.utils.config import RTConfig

    cfg = RTConfig(flatten=True)
    sb = bench_ladder._single_mesh(bigscenes.blob(n=blob_n), cfg)
    leaf, width = cfg.max_leaf_tris, cfg.bvh_width
    verts = bench_ladder._device_verts(sb, leaf, device)
    plb, pt = ploc.build_ploc_topo(*verts, leaf_size=leaf, width=width)
    trees = {"sah_host": WavefrontRenderer.from_buffers(sb, cfg,
                                                        device=device).wa,
             "karras": lbvh.build_wide_from_tris(sb, leaf_size=leaf,
                                                 width=width, device=device),
             "ploc": ploc.wide_arrays_from_ploc(plb, pt, leaf, width)}
    w, h = res
    o, d = camera_rays(Scene.framing_camera(sb, 45.0, w / h), w, h, device)
    return sah_phase(device, "config 3's mesh", verts, width, leaf, trees,
                     o, d, reps)


def phase_sah_config5(device, st, reps: int = 5, res=(1920, 1080)) -> dict:
    """Phase 12e: the sweep-SAH tree at config 5's mesh (phase 11c's
    ``st``: 999,700 triangles, 8-wide, leaf 4), K1 on phase 11c's crop of
    camera rays over the host SAH, sweep-SAH and Karras trees."""
    from vortex_rt_tpu_torch.tools import bench_ladder

    w, h = res
    o, d = camera_rays(bench_ladder.camera5(st.sb, w, h), w, h, device)
    n = min(REFIT_CROP, o.shape[0])
    a0 = (o.shape[0] - n) // 2
    o, d = o[a0:a0 + n].contiguous(), d[a0:a0 + n].contiguous()
    trees = {"sah_host": st.host_wa, "karras": st.refit_frame(0.0)}
    return sah_phase(device, "config 5's mesh", st.verts,
                     st.cfg.bvh_width, st.cfg.max_leaf_tris, trees, o, d,
                     reps)


# ------------------------------------- the megakernel engine (15a-15c)

def pool_depth(ta) -> int:
    """Levels of the merged TLAS+BLAS pool from the TLAS root to the
    deepest leaf of the deepest BLAS an instance enters (the binary walk
    pushes at most one far child a level)."""
    import numpy as np

    kind = ta.kind.cpu().numpy()
    left = ta.left.cpu().numpy()
    root = ta.inst_root.cpu().numpy()
    frontier, depth = np.zeros(1, np.int64), 0
    while frontier.size:
        depth += 1
        k, lft = kind[frontier], left[frontier]
        inner = lft[k == 0]
        enter = root[np.clip(lft[k == 1], 0, root.shape[0] - 1)]
        frontier = np.unique(np.concatenate([inner, inner + 1, enter]))
    return depth


def k6_vs_plain(label: str, ta, o, d, active=None,
                stack_depth: int = 64) -> float:
    """K6 against ``trace_rays_ref`` (run on the card: torch ops) on the
    same rays: hits, per-ray counts and steps equal to the bit."""
    from vortex_rt_tpu_torch.ops import traverse2 as t2
    from vortex_rt_tpu_torch.runtime import kernels
    from vortex_rt_tpu_torch.utils.config import LARGE_FLOAT

    before = kernels.LAUNCHES["traverse2"]
    hits, perf = t2.trace_rays(ta, o, d, stack_depth=stack_depth,
                               active=active)
    _sync(o.device)
    if o.device.type == "cuda":
        _check(kernels.LAUNCHES["traverse2"] == before + 1,
               f"{label}: K6 not launched once")
    ph, pp = t2.trace_rays_ref(ta, o, d, stack_depth=stack_depth,
                               active=active)
    err = _same_bits(f"{label}: K6 vs plain", (*hits, *perf), (*ph, *pp))
    live = o.shape[0] if active is None else int(active.sum())
    print(f"  {label}: {o.shape[0]} rays ({live} live), stack depth "
          f"{stack_depth}, {int((hits.dist < LARGE_FLOAT).sum())} hits; K6 "
          f"equals the plain version (hits, nodes_visited, tri_tests, steps "
          f"{int(perf.steps)}); steps per live ray mean "
          f"{float(perf.nodes_visited.float().sum()) / max(live, 1):.3f}")
    return err


def k6_times(label: str, ta, o, d, active=None, reps: int = 10,
             earlier=None) -> dict:
    """K6's time on these rays: CUDA events around the bare launch (the
    profiler's kernel time beside, with the launches it recorded: late in
    this run a session records only some of them), the plain version's
    and the bound of the work they need (``k6_bound``)."""
    from vortex_rt_tpu_torch.ops import traverse2 as t2
    from vortex_rt_tpu_torch.tools import walk_bounds as wb

    call = t2.kernel_call(ta, o, d, active=active)
    work = t2.rays_work(ta, o, d, active=active)
    b = wb.k6_bound(work)
    fetch = wb.k6_record_bytes(work, ta.kind.shape[0], ta.tri_idx.shape[0])
    ms = _device_ms(call, reps)
    call()
    _sync(o.device)
    prof = [e for e in _kernel_events(lambda: [call() for _ in range(reps)])
            if "traverse2_kernel" in e.key]
    recorded = sum(e.count for e in prof)
    profiler_ms = (sum(e.self_device_time_total for e in prof) / 1e3
                   / recorded if recorded else float("nan"))
    plain_ms = _elapsed_ms(lambda: t2.trace_rays_ref(ta, o, d,
                                                     active=active),
                           1, o.device)
    print(f"  {label}: K6 {ms:.4f} ms (CUDA events around the launch, mean "
          f"of {reps}; the profiler {profiler_ms:.4f} ms a launch, "
          f"{recorded} of {reps} launches recorded), plain {plain_ms:.4f} "
          f"ms; bound {b.ms:.4f} ms ({b.bound_by}: {b.bytes} B, {b.ops} "
          f"operations), {b.ms / ms:.1%} of it; the records fetch {fetch} B"
          + ("" if earlier is None
             else f"; before its redesign {earlier:.4f} ms"))
    return dict(ms=ms, profiler_ms=profiler_ms, profiler_launches=recorded,
                plain_ms=plain_ms, bound_ms=b.ms, bound_by=b.bound_by,
                bound_bytes=b.bytes, bound_ops=b.ops, rays=int(o.shape[0]),
                fetch_bytes=fetch)


def megakernel_frames(device, label: str, sb, cam, p, w: int, h: int,
                      reps: int) -> dict:
    """The megakernel engine's entry point on a frame: launch counts reset
    before ``reps`` timed frames (after a warm-up) and read after; ms a
    frame (wall, synchronised), Mrays/s, rays, peak bytes, K6 launches a
    frame; a finite image of the right shape."""
    import torch

    from vortex_rt_tpu_torch.engine.megakernel import MegakernelRenderer
    from vortex_rt_tpu_torch.runtime import kernels

    r = MegakernelRenderer.from_buffers(sb, device=device)
    out = [r.frame(cam, p, w, h)]
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    ms = _elapsed_ms(lambda: out.__setitem__(0, r.frame(cam, p, w, h)),
                     reps, device)
    launches = kernels.LAUNCHES["traverse2"]
    img, rays = out[0]
    rays = int(rays)
    _check(tuple(img.shape) == (h, w, 3) and bool(torch.isfinite(img).all()),
           f"{label}: the image is not finite or not {h}x{w}x3")
    _check(rays >= w * h * p.spp, f"{label}: {rays} rays")
    rec = dict(ms_per_frame=ms, rays_per_frame=rays,
               mrays=rays / (ms * 1e3), k6_launches=launches,
               k6_launches_per_frame=launches / reps,
               pool_depth=pool_depth(r.ta), table_bytes=r.ta.nbytes,
               scene_bytes=r.st.nbytes)
    if device.type == "cuda":
        _check(launches == reps * p.spp * p.max_depth,
               f"{label}: {launches} K6 launches in {reps} frames, not "
               f"{reps * p.spp * p.max_depth}")
        rec["peak_bytes"] = int(torch.cuda.max_memory_allocated(device))
    print(f"  {label}: {w}x{h}, spp {p.spp}, depth {p.max_depth}: "
          f"{ms:.3f} ms a frame (mean of {reps} after a warm-up), "
          f"{rec['mrays']:.3f} Mrays/s, {rays} rays a frame, K6 "
          f"{rec['k6_launches_per_frame']:g} launches a frame, peak "
          f"{rec.get('peak_bytes')} B, pool {r.ta.kind.shape[0]} nodes "
          f"({rec['table_bytes']} B), binary depth (TLAS + deepest BLAS) "
          f"{rec['pool_depth']} beside K6's stack of 64")
    _check(rec["pool_depth"] <= 64, f"{label}: the pool is "
           f"{rec['pool_depth']} levels deep, past K6's 64 stack entries")
    return rec


def phase_megakernel(device, mk_reps: int = 3, size=512,
                     hd=(1920, 1080)) -> dict:
    """Phases 15a-15c: MK-A, MK-B, and K6 against its plain version and
    timed."""
    import dataclasses as dc

    import torch

    from vortex_rt_tpu_torch import Camera, RenderParams, Scene
    from vortex_rt_tpu_torch.engine.megakernel import MegakernelRenderer
    from vortex_rt_tpu_torch.ops.traverse2 import TraversalArrays
    from vortex_rt_tpu_torch.tools.walk_timing import megakernel_waves

    _phase("phase 15a MK-A: the megakernel engine on config 2's TLAS scene "
           f"({size}x{size}, spp 4, depth 3, mirror sphere)")
    sb_a, _ = config2_scene(sphere_refl=0.6, flatten=False)
    cam_a = config2_camera()
    p_a = RenderParams(light_pos=LIGHT2, max_depth=3, spp=4)
    mk_a = megakernel_frames(device, "MK-A", sb_a, cam_a, p_a, size, size,
                             mk_reps)
    # the kernel route against the plain route (CPU) on a small frame
    small = 64
    ra = MegakernelRenderer.from_buffers(sb_a, device=device)
    img_k, n_k = ra.render(cam_a, dc.replace(p_a, spp=2), small, small)
    img_p, n_p = MegakernelRenderer.from_buffers(sb_a, device="cpu").render(
        cam_a, dc.replace(p_a, spp=2), small, small)
    diff = float(abs(img_k - img_p).max())
    _check(n_k == n_p and diff <= IMG_ATOL,
           f"MK-A {small}x{small} spp 2: {n_k} vs {n_p} rays, image diff "
           f"{diff}")
    print(f"  MK-A at {small}x{small}, spp 2: the card's frame equals the "
          f"CPU's ({n_k} rays both, image max diff {diff:.3g})")
    mk_a["plain_frame_diff"] = diff

    _phase("phase 15b MK-B: the megakernel engine on the atrium's TLAS "
           f"({hd[0]}x{hd[1]}, spp 1, depth 2; the CLI's -m atrium "
           "--engine megakernel)")
    t0 = time.perf_counter()
    sb_b, _ = atrium_scene(flatten=False)
    build_s = time.perf_counter() - t0
    w, h = hd
    cam_b = Scene.framing_camera(sb_b, 45.0, w / h, zoom=1.0)
    p_b = RenderParams(spp=1, max_depth=2)
    mk_b = megakernel_frames(device, "MK-B", sb_b, cam_b, p_b, w, h,
                             mk_reps)
    mk_b["host_build_s"] = build_s
    rb = MegakernelRenderer.from_buffers(sb_b, device=device)
    waves_b = megakernel_waves(rb, cam_b, p_b, w, h)
    live_b = [int(a.sum()) for _, _, a in waves_b]
    mk_b["live_per_wave"] = live_b
    print(f"  MK-B: host build (native, TLAS over 29 BLASes) {build_s:.2f} s;"
          f" live lanes per wave {live_b} (no instance reflects, so the "
          f"second wave's K6 launch has no live lane: every thread reads "
          f"its flag and writes the initial record)")

    _phase("phase 15c K6 vs its plain version, and timed")
    err = 0.0
    waves_a = megakernel_waves(ra, cam_a, p_a, size, size)
    for k, (o, d, act) in enumerate(waves_a):
        err = max(err, k6_vs_plain(f"MK-A wave {k}", ra.ta, o, d,
                                   None if k == 0 else act))
    o, d, _ = waves_b[0]
    err = max(err, k6_vs_plain("MK-B primary wave", rb.ta, o, d))
    sb_i, _ = instances_scene()
    ta_i = TraversalArrays.from_scene(sb_i).to(device)
    g = torch.Generator().manual_seed(5)
    n = 132 * 128 * 4 + 17
    oi = ((torch.rand(n, 3, generator=g) - 0.5) * 12).to(device)
    di = torch.nn.functional.normalize(torch.randn(n, 3, generator=g))
    di = di.to(device)
    act_i = torch.arange(n, device=device) % 3 != 1
    for active in (None, act_i):
        for depth in (64, 4):  # 4: the stack overflows, clamped as in JAX
            err = max(err, k6_vs_plain("transformed instances", ta_i, oi,
                                       di, active, depth))
    print(f"  binary depth of the transformed-instances pool "
          f"{pool_depth(ta_i)} beside K6's stack of 64")
    from vortex_rt_tpu_torch.ops.traverse2 import chain_pool

    ta_c = chain_pool(100, device)
    nc = 20000
    yz = torch.rand(nc, 2, generator=g) * 1.8 - 0.9
    oc = torch.stack([torch.full((nc,), -1.0), yz[:, 0], yz[:, 1]], 1)
    dc = torch.nn.functional.normalize(
        torch.tensor([1.0, 0.0, 0.0]) + 1e-3 * torch.randn(nc, 3, generator=g))
    for depth in (64, 4):
        err = max(err, k6_vs_plain("chain_pool(100), 102 levels", ta_c,
                                   oc.to(device), dc.to(device),
                                   torch.arange(nc, device=device) % 5 != 2,
                                   depth))
    times = {}
    if device.type == "cuda":
        o, d, _ = waves_a[0]
        times["mk_a_primary"] = k6_times(
            "MK-A primary wave", ra.ta, o, d,
            earlier=EARLIER_WALK_MS["mk_a_primary"])
        o, d, act = waves_a[1]
        times["mk_a_bounce1"] = k6_times(
            "MK-A wave 1 (bounce)", ra.ta, o, d, act,
            earlier=EARLIER_WALK_MS["mk_a_bounce1"])
        o, d, _ = waves_b[0]
        times["mk_b_primary"] = k6_times(
            "MK-B primary wave", rb.ta, o, d, reps=5,
            earlier=EARLIER_WALK_MS["mk_b_primary"])
    del waves_a, waves_b, ra, rb
    _phase("phase 15d K2 on the atrium's 4-wide TLAS build at "
           f"{w}x{h}")
    k2_hd = phase_k2_atrium(device, sb_b, cam_b, w, h)
    return dict(mk_a=mk_a, mk_b=mk_b, max_abs_err=err, times=times,
                k2_hd=k2_hd, atrium_tlas=sb_b)


def phase_k2_atrium(device, sb, cam, w: int, h: int, crop: int = 31,
                    reps: int = 10) -> dict:
    """15d: K2 on ``sb``'s 4-wide TLAS build (``RTConfig()``), the
    frame's camera rays: hits and steps against the plain version on
    every ``crop``-th ray, the whole wave timed (CUDA events around the
    bare launch) beside ``k2_bound`` and the plain version on the crop."""
    import torch

    from vortex_rt_tpu_torch import RTConfig, WavefrontRenderer
    from vortex_rt_tpu_torch.ops import packet_walk as pw
    from vortex_rt_tpu_torch.runtime import kernels
    from vortex_rt_tpu_torch.tools import walk_bounds as wb

    cfg = RTConfig()
    r = WavefrontRenderer.from_buffers(sb, cfg, device=device)
    _check(r.walk is pw.trace_packets_walk and r.wa.width == 4
           and r.wa.num_tlas > 0, "the atrium's TLAS build is not on K2")
    o, d = camera_rays(cam, w, h, device)
    oc, dc = o[::crop].contiguous(), d[::crop].contiguous()
    before = kernels.LAUNCHES["packet_walk"]
    k, ks = pw.trace_packets_walk(r.wa, oc, dc)
    _sync(device)
    if device.type == "cuda":
        _check(kernels.LAUNCHES["packet_walk"] == before + 1,
               "15d: K2 not launched once")
    pp, ps = pw.trace_packets_walk_ref(r.wa, oc, dc)
    err = compare_hits(f"atrium TLAS {w}x{h}, 1 ray in {crop}", k, pp,
                       ks, ps)
    plain_ms = _elapsed_ms(lambda: pw.trace_packets_walk_ref(r.wa, oc, dc),
                           1, device)
    whole, steps, work = pw.walk_work_4(r.wa, o, d)
    b = wb.k2_bound(work)
    rec = dict(max_abs_err=err, rays=int(o.shape[0]), crop_rays=int(
        oc.shape[0]), plain_ms_crop=plain_ms, bound_ms=b.ms,
        bound_by=b.bound_by, depth=int(r.wa.depth),
        stack_entries=pw.stack_entries(r.wa),
        mean_steps=float(steps.float().mean()))
    if device.type == "cuda":
        call = pw.kernel_call(r.wa, o, d)
        hits, ksteps = call()
        _check(all(torch.equal(x, y) for x, y in zip(
            (*hits, ksteps), (*whole, steps))), "15d: K2's hits or steps "
            "on the whole wave differ from the plain version's")
        rec["ms"] = _device_ms(call, reps)
        print(f"  K2 {w}x{h} wave ({rec['rays']} rays, depth {rec['depth']}, "
              f"{rec['stack_entries']} stack entries a ray): {rec['ms']:.4f} "
              f"ms (CUDA events; before its redesign "
              f"{EARLIER_WALK_MS['k2_atrium_tlas_1080p']:.4f}), bound "
              f"{b.ms:.4f} ms ({b.bound_by}) = {b.ms / rec['ms']:.1%}; mean "
              f"steps {rec['mean_steps']:.3f}; plain {plain_ms:.4f} ms on the "
              f"{rec['crop_rays']}-ray crop")
    return rec


def phase_k7(device, check_rows: int = K7_ROWS[0], check_steps: int = 500
             ) -> dict:
    import torch

    from vortex_rt_tpu_torch.runtime import kernels
    from vortex_rt_tpu_torch.tools import exp_hbm_walk as hw
    from vortex_rt_tpu_torch.tools import walk_bounds as wb

    tab = hw.make_table(check_rows, device)
    err = 0
    for words in (int(x) for x in K7_WORDS.split(",")):
        for k in (int(x) for x in K7_KS.split(",")):
            got = hw.run_walks(tab, check_steps, k, words)
            want = hw.run_walks_ref(tab, check_steps, k, words)
            err = max(err, abs(int(got[0]) - int(want[0])))
            _check(torch.equal(got, want), f"K7 k={k} words={words}: sum "
                   f"{int(got[0])} vs plain {int(want[0])}")
    print(f"  run_walks == run_walks_ref at {check_rows} rows, "
          f"{check_steps} steps, k in {K7_KS}, words in {K7_WORDS}")
    ms = _device_ms(lambda: hw.run_walks(tab, K7_STEPS, 1), 5)
    plain_ms = _elapsed_ms(lambda: hw.run_walks_ref(tab, K7_STEPS, 1), 2,
                           device)
    b = wb.k7_bound(check_rows, K7_STEPS, 1, hw.W)
    print(f"  {K7_STEPS} steps k=1, 512-B rows: kernel {ms:.4f} ms "
          f"(device), plain {plain_ms:.4f} ms, bound {b.ms:.6f} ms "
          f"({b.bound_by}; the probe measures latency, not this)")
    del tab

    # ---- the probe's entry point: counts reset just before, read after
    kernels.reset_launches()
    curves = {}
    for rows in K7_ROWS:
        curves[rows] = hw.main(["--rows", str(rows), "--steps",
                                str(K7_STEPS), "--ks", K7_KS, "--words",
                                K7_WORDS])
    _sync(device)
    launches = kernels.LAUNCHES["hbm_walk"]
    _check(launches > 0, "the probe launched no hbm_walk")
    return dict(launches=launches, launches_per_frame=None,
                max_abs_err=float(err), ms=ms, plain_ms=plain_ms,
                bound_ms=b.ms, bound_by=b.bound_by, curves=curves)


# ---------------------------- the host API surface and the CLI (17a-17e)

def run_cli(argv, device) -> tuple:
    """``cli.main(argv)`` with its standard output captured (and echoed,
    indented) and the float images it writes recorded: (text, {path:
    (H, W, 3) float32 image}).  On a card the CLI runs on its default
    device; a CPU rehearsal passes ``--device cpu``."""
    import contextlib
    import io

    import numpy as np

    from vortex_rt_tpu_torch import cli
    from vortex_rt_tpu_torch.utils import image

    images = {}
    orig = image.write_ppm

    def record(path, img):
        images[str(path)] = np.asarray(img, np.float32).copy()
        orig(path, img)

    image.write_ppm = record
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(list(argv) + (["--device", "cpu"]
                                        if device.type == "cpu" else []))
    finally:
        image.write_ppm = orig
    text = buf.getvalue()
    for line in text.splitlines():
        print("  cli| " + (line if len(line) < 300 else line[:300] + " ..."))
    _check(rc == 0, f"cli.main({argv}) returned {rc}")
    return text, images


def cli_numbers(text: str) -> tuple:
    """(ms, rays, Mrays/s) of the CLI's ``rendered ...`` line."""
    import re

    m = re.search(r"engine=\S+: ([\d.]+) ms, (\d+) rays, ([\d.]+) Mrays/s",
                  text)
    _check(m is not None, "the CLI printed no 'rendered' line")
    return float(m.group(1)), int(m.group(2)), float(m.group(3))


def write_obj(path: str, mesh) -> None:
    """A mesh's triangles as an OBJ: a v, vn and vt line a corner, every
    float by %.9g (which reads back to the same float32), then the faces."""
    import numpy as np

    v, n, uv = (np.stack(c, 1).reshape(-1, k).tolist() for c, k in (
        ((mesh.v0, mesh.v1, mesh.v2), 3), ((mesh.n0, mesh.n1, mesh.n2), 3),
        ((mesh.uv0, mesh.uv1, mesh.uv2), 2)))
    with open(path, "w") as f:
        f.write("# written by chip_smoke.py: one v/vn/vt a corner\n")
        f.write("\n".join("v %.9g %.9g %.9g" % tuple(x) for x in v) + "\n")
        f.write("\n".join("vn %.9g %.9g %.9g" % tuple(x) for x in n) + "\n")
        f.write("\n".join("vt %.9g %.9g" % tuple(x) for x in uv) + "\n")
        f.write("\n".join(
            "f {0}/{0}/{0} {1}/{1}/{1} {2}/{2}/{2}".format(
                3 * k + 1, 3 * k + 2, 3 * k + 3)
            for k in range(len(v) // 3)) + "\n")


def phase_cli_config3(device, w: int = 1920, h: int = 1080,
                      blob_n: int = 187) -> dict:
    """17a: ladder config 3's render through the CLI and the OBJ loader:
    blob(n) written to an OBJ, read back (every array equal), rendered by
    ``cli.main`` at spp 4, depth 3, shadow rays, path traced (launch
    counts reset before), and held against the same frame rendered by
    ``WavefrontRenderer`` from the mesh in memory."""
    import os
    import tempfile

    import numpy as np

    from vortex_rt_tpu_torch import (
        RenderParams, RTConfig, Scene, WavefrontRenderer,
    )
    from vortex_rt_tpu_torch.io.obj import load_obj
    from vortex_rt_tpu_torch.models.bigscenes import blob
    from vortex_rt_tpu_torch.runtime import kernels

    mesh = blob(n=blob_n)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "blob.obj")
        t0 = time.perf_counter()
        write_obj(path, mesh)
        write_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        back = load_obj(path)
        load_s = time.perf_counter() - t0
        for f in ("v0", "v1", "v2", "n0", "n1", "n2", "uv0", "uv1", "uv2"):
            _check(np.array_equal(getattr(back, f), getattr(mesh, f)),
                   f"the OBJ's {f} differs from the mesh's")
        out = os.path.join(tmp, "cli.ppm")
        kernels.reset_launches()
        text, images = run_cli(["-m", path, "-w", str(w), "-H", str(h),
                                "-s", "4", "-d", "3", "--shadow",
                                "--pathtrace", "-o", out], device)
        _sync(device)
        launches = dict(kernels.LAUNCHES)
        img_cli = images[out]
    cli_ms, cli_rays, cli_mrays = cli_numbers(text)
    cuda = device.type == "cuda"
    _check(not cuda or launches["traverse_packet"] == 20,
           f"the CLI's config-3 frame launched {launches}")
    sc = Scene()
    sc.add_instance(sc.add_mesh(mesh))
    cfg = RTConfig(flatten=True)
    sb = sc.build(cfg)
    r = WavefrontRenderer.from_buffers(sb, cfg, device=device)
    cam = Scene.framing_camera(sb, 45.0, w / h)
    p = RenderParams(spp=4, max_depth=3, shadow=True, pathtrace=True)
    img, rays = r.render(cam, p, w, h)
    diff = float(np.abs(img_cli - np.clip(img, 0, 1)).max())
    _check(rays == cli_rays and diff <= IMG_ATOL,
           f"the CLI's frame ({cli_rays} rays) differs from the in-memory "
           f"frame ({rays} rays) by {diff}")
    frame_ms = _elapsed_ms(lambda: r.render(cam, p, w, h), 2, device)
    print(f"  OBJ: {mesh.num_tris} triangles, {size} B, written in "
          f"{write_s:.3f} s, loaded in {load_s:.3f} s (every array equal)")
    print(f"  the CLI's frame: {cli_ms:.1f} ms as the CLI times it (the "
          f"renderer's tables built and moved to the card, then the "
          f"frame), {cli_rays} rays, {cli_mrays:.2f} Mrays/s; the frame "
          f"alone (render, image read back) {frame_ms:.3f} ms = "
          f"{rays / frame_ms / 1e3:.3f} Mrays/s; K1 launches "
          f"{launches['traverse_packet']}; image max diff vs the in-memory "
          f"frame {diff:.3g}")
    return dict(obj_bytes=size, obj_write_s=write_s, obj_load_s=load_s,
                cli_ms=cli_ms, cli_mrays=cli_mrays, rays=rays,
                frame_ms=frame_ms, mrays=rays / frame_ms / 1e3,
                k1_launches=launches["traverse_packet"], max_abs_err=diff)


def _plain_stats(steps, work) -> dict:
    """A wave's counters from the plain walk's per-ray steps and work."""
    import torch

    from vortex_rt_tpu_torch.ops.traverse_packet import WARP

    s = steps.to(torch.int64)
    pad = torch.cat([s, s.new_zeros((-len(s)) % WARP)])
    return dict(steps=int(s.max()),
                packet_steps=int(pad.reshape(-1, WARP).max(1).values.sum()),
                ray_steps=int(s.sum()), int_steps=int(work.internal.sum()),
                tri_steps=int(work.leaf.sum()),
                ins_steps=int(work.instance.sum()))


def _kernel_ms_pair(call_d, call_s, reps: int, name: str,
                    profile: bool = True) -> dict:
    """The default and the STATS instantiation of one wave timed in turns
    (default, stats, stats, default): CUDA events around the bare launch,
    and with ``profile`` the profiler's kernel time (every kernel whose
    name holds ``name``; NaN, not measured, without)."""
    ev = {"default": [], "stats": []}
    prof = {"default": [], "stats": []}
    for which in ("default", "stats", "stats", "default"):
        call = call_d if which == "default" else call_s
        ev[which].append(_device_ms(call, reps))
        prof[which].append(_profiled_kernel_ms(call, reps, [name])[name]
                           if profile else float("nan"))
    return {k: dict(ms=sum(ev[k]) / 2, profiler_ms=sum(prof[k]) / 2)
            for k in ev}


def stats_vs_plain(label: str, r, cam, p, size: int, device,
                   reps: int = 20) -> dict:
    """``perf_trace`` of one frame through the walks' counting
    instantiations, its waves captured: per wave, the hits, steps and
    per-ray internal and instance steps equal the plain walk's
    (``walk_work`` / ``walk_work_4``) word for word, and the counters
    equal the plain sums and maxima; each wave's default and STATS
    kernels timed in turns (CUDA events; the profiler's kernel time
    beside on the primary wave)."""
    import torch

    from vortex_rt_tpu_torch.ops import packet_walk as pw
    from vortex_rt_tpu_torch.ops import traverse_packet as tp
    from vortex_rt_tpu_torch.runtime import kernels
    from vortex_rt_tpu_torch.tools import walk_bounds as wb

    k1 = r.wa.width == 8
    work_fn = tp.walk_work if k1 else pw.walk_work_4
    call_fn = tp.kernel_call if k1 else pw.kernel_call
    kname = "traverse_packet_kernel" if k1 else "packet_walk_kernel"
    waves = []
    walk = r.walk

    def capture(wa, o, d, **kw):
        res = walk(wa, o, d, **kw)
        waves.append((o.clone(), d.clone(), {
            k: (v.clone() if torch.is_tensor(v) else v)
            for k, v in kw.items()}, res))
        return res

    r.walk = capture
    kernels.reset_launches()
    try:
        perf = r.perf_trace(cam, p, size, size)
    finally:
        r.walk = walk
    _sync(device)
    launches = dict(kernels.LAUNCHES)  # (before the timing launches)
    names = [f"{k}{b}" for b in range(p.max_depth)
             for k in (("trace", "shadow") if p.shadow else ("trace",))]
    _check(len(waves) == len(names) * p.spp,
           f"{label}: {len(waves)} waves for {names}")
    stats_lib = "traverse_packet_stats" if k1 else "packet_walk_stats"
    _check(device.type != "cuda" or launches[stats_lib] == len(waves),
           f"{label}: perf_trace launched {launches}")
    out = {"perf": perf, "waves": {}, "launches": launches}
    err = 0.0
    for name, (o, d, kw, (hk, sk, kinds)) in zip(names, waves):
        _check(kw.pop("stats") is True, f"{label} {name} did not count")
        hp, sp, work = work_fn(r.wa, o, d, **kw)
        compare_hits(f"{label} {name}", hk, hp, sk, sp)
        _check(torch.equal(kinds.internal, work.internal.to(torch.int32))
               and torch.equal(kinds.instance,
                               work.instance.to(torch.int32)),
               f"{label} {name}: per-ray step kinds differ from walk_work")
        want = _plain_stats(sp, work)
        got = perf[name]
        err = max(err, max(abs(got[k] - v) for k, v in want.items()))
        _check(all(got[k] == v for k, v in want.items()),
               f"{label} {name}: {got} against the plain {want}")
        rec = dict(counters=got, live=int(kw["active"].sum()))
        if name == "trace0" and device.type == "cuda":
            t = _kernel_ms_pair(call_fn(r.wa, o, d, **kw),
                                call_fn(r.wa, o, d, stats=True, **kw),
                                reps, kname)
            b = (wb.k1_bound if k1 else wb.k2_bound)(work)
            rec.update(default=t["default"], stats=t["stats"],
                       plain_ms=_elapsed_ms(
                           lambda: work_fn(r.wa, o, d, **kw), 1, device),
                       bound_ms=b.ms, bound_by=b.bound_by)
        elif device.type == "cuda":
            rec.update(_kernel_ms_pair(call_fn(r.wa, o, d, **kw),
                                       call_fn(r.wa, o, d, stats=True, **kw),
                                       reps, kname, profile=False))
        out["waves"][name] = rec
        print(f"  {label} {name}: {rec['live']} live rays, counters {got} "
              f"= the plain walk's; default "
              f"{rec.get('default', {}).get('ms', float('nan')):.4f} ms "
              f"(profiler {rec.get('default', {}).get('profiler_ms', float('nan')):.4f}),"
              f" STATS {rec.get('stats', {}).get('ms', float('nan')):.4f} ms "
              f"(profiler {rec.get('stats', {}).get('profiler_ms', float('nan')):.4f})")
    out["max_abs_err"] = err
    return out


def alpha_stats_vs_plain(label: str, r, cam, size: int, device) -> float:
    """One alpha-mode wave (camera rays of ``cam``) through the counting
    instantiation against ``walk_work``'s counts, word for word."""
    import torch

    from vortex_rt_tpu_torch.ops import packet_walk as pw
    from vortex_rt_tpu_torch.ops import traverse_packet as tp
    from vortex_rt_tpu_torch.tools.bench_ladder import ALPHA6

    k1 = r.wa.width == 8
    o, d = camera_rays(cam, size, size, device)
    walk = tp.trace_packets if k1 else pw.trace_packets_walk
    work_fn = tp.walk_work if k1 else pw.walk_work_4
    hk, sk, kinds = walk(r.wa, o, d, alpha_ref=ALPHA6, stats=True)
    _sync(device)
    hp, sp, work = work_fn(r.wa, o, d, alpha_ref=ALPHA6)
    err = compare_hits(label, hk, hp, sk, sp)
    _check(torch.equal(kinds.internal, work.internal.to(torch.int32))
           and torch.equal(kinds.instance, work.instance.to(torch.int32)),
           f"{label}: per-ray step kinds differ from walk_work")
    print(f"  {label}: {size}x{size} rays, counters "
          f"{_plain_stats(sp, work)} equal the plain walk's")
    return err


def phase_cli_perf(device, r6, r6_tlas, cam6, size: int = 512,
                   alpha_size: int = 192) -> dict:
    """17b: the CLI's --perf on the card (config 2's shape: cornell,
    512x512, depth 2, shadow rays), then ``perf_trace`` on the renderer
    the CLI builds, and on its 4-wide build, each wave's counters held to
    the plain walk's; one alpha wave of row 6's scene through K1's and
    K2's counting instantiations."""
    import ast
    import os
    import tempfile

    from vortex_rt_tpu_torch import (
        RenderParams, RTConfig, Scene, WavefrontRenderer, cli,
    )
    from vortex_rt_tpu_torch.runtime import kernels

    with tempfile.TemporaryDirectory() as tmp:
        kernels.reset_launches()
        text, _ = run_cli(["-m", "cornell", "-w", str(size), "-H",
                           str(size), "-d", "2", "--shadow", "--perf",
                           "-o", os.path.join(tmp, "o.ppm")], device)
        _sync(device)
        launches_cli = dict(kernels.LAUNCHES)
    printed = {}
    for line in text.splitlines():
        if line.startswith("PERF.trace: "):
            k, v = line[len("PERF.trace: "):].split("=", 1)
            printed[k] = ast.literal_eval(v)
    cuda = device.type == "cuda"
    _check(not cuda or launches_cli["traverse_packet_stats"] == 4,
           f"the CLI's --perf launched {launches_cli}")
    sb = cli.build_scene("cornell").build(RTConfig(flatten=True))
    cam = Scene.framing_camera(sb, 45.0, 1.0)
    p = RenderParams(max_depth=2, shadow=True)
    out = {"cli_launches": launches_cli["traverse_packet_stats"],
           "cli_k1_launches": launches_cli["traverse_packet"]}
    for key, cfg in (("k1", RTConfig(flatten=True)),
                     ("k2", RTConfig(flatten=True, bvh_width=4))):
        r = WavefrontRenderer.from_buffers(sb, cfg, device=device)
        out[key] = stats_vs_plain(f"{key} ({r.wa.width}-wide)", r, cam, p,
                                  size, device)
    _check(out["k1"]["perf"] == printed,
           "perf_trace on the CLI's renderer differs from the CLI's "
           "PERF.trace lines")
    err = max(out["k1"]["max_abs_err"], out["k2"]["max_abs_err"])
    out["alpha_err"] = max(
        alpha_stats_vs_plain("row 6 alpha wave, K1", r6, cam6, alpha_size,
                             device),
        alpha_stats_vs_plain("row 6 alpha wave, K2 (TLAS)", r6_tlas, cam6,
                             alpha_size, device))
    out["max_abs_err"] = max(err, out["alpha_err"])
    if cuda:
        for name in ("traverse_packet", "packet_walk"):
            log = kernels.load(name).build_log
            print(f"  {name} ptxas (default <.., false>, STATS <.., true>):")
            for line in log.splitlines():
                if ("Compiling entry" in line or "registers" in line
                        or "stack frame" in line):
                    print("    " + line.split("ptxas info    : ")[-1].strip())
    print(f"  the CLI's --perf: {out['cli_launches']} launches of K1's "
          f"counting instantiation, {out['cli_k1_launches']} of K1; "
          f"perf_trace equals the CLI's PERF.trace lines")
    return out


def phase_cli_scope(device, size: int = 512, n_frames: int = 4) -> dict:
    """17c: --scope-out on config 2's shape: the JSON parses, its spans
    tile one timeline and their labels equal ``frame_profile``'s."""
    import os
    import tempfile

    from vortex_rt_tpu_torch import (
        RenderParams, RTConfig, Scene, WavefrontRenderer, cli,
    )

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "scope.json")
        run_cli(["-m", "cornell", "-w", str(size), "-H", str(size), "-d",
                 "2", "--shadow", "--scope-out", path, "-o",
                 os.path.join(tmp, "o.ppm")], device)
        with open(path) as f:
            evs = json.load(f)["traceEvents"]
    spans = sorted((e for e in evs if e["ph"] == "X"), key=lambda e: e["ts"])
    for a, b in zip(spans, spans[1:]):
        _check(abs(a["ts"] + a["dur"] - b["ts"]) < 1e-6,
               "the scope's spans do not tile its timeline")
    cfg = RTConfig(flatten=True)
    sb = cli.build_scene("cornell").build(cfg)
    r = WavefrontRenderer.from_buffers(sb, cfg, device=device)
    prof = r.frame_profile(Scene.framing_camera(sb, 45.0, 1.0),
                           RenderParams(max_depth=2, shadow=True), size,
                           size, n_frames=n_frames)
    labels = [e["name"] for e in spans]
    _check(labels == [x["stage"] for x in prof],
           f"scope stages {labels} differ from frame_profile's")
    counters = {e["name"] for e in evs if e["ph"] == "C"}
    print("  scope stages (ms): " + ", ".join(
        f"{e['name']} {e['dur'] / 1e3:.2f}" for e in spans))
    print("  frame_profile (ms): " + ", ".join(
        f"{x['stage']} {x['ms']:.2f}" for x in prof)
          + f"; counter tracks {sorted(counters)}")
    return dict(scope_ms={e["name"]: e["dur"] / 1e3 for e in spans},
                profile=prof)


def phase_cli_compare(device, hd=(1920, 1080)) -> dict:
    """17d: --compare on cornell at 256x256, depth 2 (PASS against the
    golden oracle), then MK-B through the CLI (atrium, --engine
    megakernel, spp 1, depth 2)."""
    import os
    import tempfile

    from vortex_rt_tpu_torch.runtime import kernels

    with tempfile.TemporaryDirectory() as tmp:
        text, _ = run_cli(["-m", "cornell", "-w", "256", "-H", "256", "-d",
                           "2", "--compare", "-o",
                           os.path.join(tmp, "c.ppm")], device)
        line = next((ln for ln in text.splitlines()
                     if ln.startswith("COMPARE:")), "")
        _check("PASS" in line, f"--compare did not pass: {line!r}")
        kernels.reset_launches()
        t0 = time.perf_counter()
        text, _ = run_cli(["-m", "atrium", "-w", str(hd[0]), "-H",
                           str(hd[1]), "-d", "2", "--engine", "megakernel",
                           "-o", os.path.join(tmp, "mk.ppm")], device)
        call_s = time.perf_counter() - t0
        _sync(device)
        launches = dict(kernels.LAUNCHES)
    ms, rays, mrays = cli_numbers(text)
    _check(device.type != "cuda" or launches["traverse2"] == 2,
           f"MK-B through the CLI launched {launches}")
    print(f"  MK-B through the CLI: {ms:.1f} ms as the CLI times it (the "
          f"records packed on the card, then the frame), {rays} rays, "
          f"{mrays:.2f} Mrays/s; the whole call with the host build "
          f"{call_s:.2f} s; K6 launches {launches['traverse2']}")
    return dict(compare=line, mk_b_cli_ms=ms, mk_b_rays=rays,
                mk_b_mrays=mrays, mk_b_call_s=call_s,
                k6_launches=launches["traverse2"])


def phase_rtu(device, sb, size: int = 512) -> dict:
    """17e: the RT-unit facade on the atrium's 4-wide TLAS build: the
    reference's persistent kernel loop over ``size``^2 camera rays with an
    any-hit handler that rejects odd triangle ids (CONT) and accepts the
    others; the closest hits (mask, distance, triangle and instance ids)
    equal the pool path's (``walk_lanes`` rounds with the same action) to
    the bit.  Then the device API once: dev_open, copy, start,
    ready_wait, dump_perf."""
    import numpy as np
    import torch

    from vortex_rt_tpu_torch import Scene
    from vortex_rt_tpu_torch.engine import rtu
    from vortex_rt_tpu_torch.golden.renderer import generate_rays
    from vortex_rt_tpu_torch.ops.packet_walk import trace_packets_walk
    from vortex_rt_tpu_torch.ops.traverse_wide import (
        WideArrays, commit, init_state_lanes, lanes_hits, walk_lanes,
    )
    from vortex_rt_tpu_torch.runtime import kernels
    from vortex_rt_tpu_torch.runtime.device import (
        VX_DCR_BASE_RTX_TLAS_PTR, dev_open,
    )
    from vortex_rt_tpu_torch.utils.config import (
        COMMIT_ACCEPT, COMMIT_CONT, LARGE_FLOAT,
    )

    wa = WideArrays.from_scene(sb, width=4).to(device)
    o, d = generate_rays(Scene.framing_camera(sb, 45.0, 1.0), size, size)
    n = size * size
    unit = rtu.RTUnit(wa, lanes=n, anyhit=True, queue_capacity=n)
    dist = np.full(n, np.nan, np.float32)
    tri = np.full(n, -1, np.int64)
    inst = np.full(n, -1, np.int64)
    rounds, any_rounds = 0, 0
    kernels.reset_launches()
    _sync(device)
    t0 = time.perf_counter()
    unit.trace_ray(o, d, payload_addr=np.arange(n))
    while True:
        work = unit.get_work()
        if work.size == 0:
            break
        rounds += 1
        ty, _ = rtu.decode_work(work)
        if int(ty[0]) == rtu.SHADER_ANY:
            any_rounds += 1
            odd = unit.get_attr(work, rtu.VX_RT_HIT_TRI_IDX) % 2 == 1
            unit.commit(work[odd], rtu.VX_RT_COMMIT_CONT)
            unit.commit(work[~odd], rtu.VX_RT_COMMIT_ACCEPT)
            continue
        pay = unit.get_attr(work, rtu.VX_RT_RAY_PAYLOAD_ADDR)
        if int(ty[0]) == rtu.SHADER_CLOSEST:
            dist[pay] = unit.get_attr(work, rtu.VX_RT_HIT_DIST)
            tri[pay] = unit.get_attr(work, rtu.VX_RT_HIT_TRI_IDX)
            inst[pay] = unit.get_attr(work, rtu.VX_RT_HIT_BLAS_IDX)
        else:
            dist[pay] = LARGE_FLOAT
        unit.commit(work, rtu.VX_RT_COMMIT_TERM)
        _check(rounds < 10_000, "the RT unit's loop did not drain")
    _sync(device)
    dt = time.perf_counter() - t0
    k3 = kernels.LAUNCHES["traverse_wide"]
    _check(unit.active_rays() == 0 and not np.isnan(dist).any(),
           "the RT unit's loop left rays without a result")
    _check(device.type != "cuda" or k3 > 0, "the RT unit launched no K3")
    # the pool path: walk_lanes rounds, the same action on the suspended
    ot = torch.as_tensor(o, device=device)
    dt_ = torch.as_tensor(d, device=device)
    lanes = tuple(a[:, k].contiguous() for a in (ot, dt_) for k in range(3))
    st = init_state_lanes(*lanes)
    pool_rounds = 0
    while True:
        st = walk_lanes(wa, *lanes, state=st, suspend=True)
        pool_rounds += 1
        if not bool(st.suspended.any()):
            break
        act = torch.where(st.pend_tri % 2 == 1, COMMIT_CONT, COMMIT_ACCEPT)
        st = commit(st, torch.where(st.suspended, act, COMMIT_CONT)
                    .to(torch.int32))
    h = lanes_hits(wa, st)
    hd = h.dist.cpu().numpy()
    hit = hd < LARGE_FLOAT
    _check(np.array_equal(hit, dist < LARGE_FLOAT)
           and np.array_equal(hd[hit].view(np.int32),
                              dist[hit].view(np.int32))
           and np.array_equal(h.tri.cpu().numpy()[hit], tri[hit])
           and np.array_equal(h.inst.cpu().numpy()[hit], inst[hit]),
           "the RT unit's closest hits differ from the pool path's")
    print(f"  RT unit: {n} rays on the atrium's TLAS in {dt:.3f} s = "
          f"{n / dt / 1e6:.3f} Mrays/s (host clock, loop to drain), "
          f"{rounds} get_work rounds ({any_rounds} any-hit), {k3} K3 "
          f"launches; {int(hit.sum())} closest hits equal the pool path's "
          f"({pool_rounds} walk_lanes rounds) to the bit")
    # the device API (vortex.h) once
    dev = dev_open(None if device.type == "cuda" else "cpu")
    _check(dev.platform == "gpu" or device.type != "cuda",
           f"dev_open() opened {dev.platform}")
    dev.copy_to_dev("o", o)
    dev.copy_to_dev("d", d)
    dev.dcr_write(VX_DCR_BASE_RTX_TLAS_PTR, "tlas")
    dev.upload_kernel("trace", lambda a, b: trace_packets_walk(wa, a, b))
    dev.start("trace", dev.buffer("o"), dev.buffer("d"))
    hits, _ = dev.ready_wait()
    _check(bool((hits.dist < LARGE_FLOAT).any()), "the device API's trace hit "
           "nothing")
    perf = dev.dump_perf()
    print(f"  device API: {dev.platform}, dump_perf {perf}")
    return dict(rays=n, seconds=dt, rays_per_s=n / dt, rounds=rounds,
                any_rounds=any_rounds, k3_launches=k3,
                pool_rounds=pool_rounds, dump_perf=perf)


# ------------------------------- multi-device rendering (18a-18d)
#
# Each phase starts its ranks with torch.multiprocessing (spawn), every
# rank on the same card through gloo and a file:// store in a temporary
# directory (parallel/launch.spawn); a rank returns its readings and its
# kernels.LAUNCHES, and one that raises fails the launch.  Frame times of
# several ranks sharing one card measure no scaling.

MD_RANKS_LABEL = "ranks on one H100"


def _md_step_ms(step, args, device) -> float:
    """Wall ms of one ``step`` after a warm-up, both ranks starting
    together (a barrier), device-synchronised."""
    import torch.distributed as dist

    step(*args)
    _sync(device)
    dist.barrier()
    t0 = time.perf_counter()
    step(*args)
    _sync(device)
    return (time.perf_counter() - t0) * 1e3


def md_rank_tiles(rank: int, device: str, c3, mk_a) -> dict:
    """18a and 18b on one rank: each host API once (launch counts reset
    before it and read after; the image gathered), then the frame's
    step timed after a warm-up.  ``c3`` and ``mk_a``: (buffers, camera,
    params, width, height)."""
    import torch

    from vortex_rt_tpu_torch import RTConfig, WavefrontRenderer
    from vortex_rt_tpu_torch.engine.megakernel import (
        CameraArrays, LightArrays, MegakernelRenderer,
    )
    from vortex_rt_tpu_torch.parallel import tiles
    from vortex_rt_tpu_torch.parallel.mesh import Mesh
    from vortex_rt_tpu_torch.runtime import kernels

    dev = torch.device(device)
    mesh = Mesh.create(("tiles",), device=dev)
    out = dict(rank=rank, device=str(mesh.device), backend=mesh.backend)
    for key, api, (sb, cam, p, w, h), kernel in (
            ("18a", tiles.render_tiled_wavefront, c3, "traverse_packet"),
            ("18b", tiles.render_tiled, mk_a, "traverse2")):
        host0 = mesh.host_bytes
        _sync(dev)
        kernels.reset_launches()
        t0 = time.perf_counter()
        img, rays = api(sb, cam, p, w, h, mesh=mesh)
        _sync(dev)
        api_s = time.perf_counter() - t0
        host_bytes = mesh.host_bytes - host0
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        _check(dev.type != "cuda" or launches.get(kernel, 0) > 0,
               f"{key} rank {rank}: no {kernel} launch ({launches})")
        cam_t = CameraArrays.from_camera(cam, dev)
        light = LightArrays.from_params(p, dev)
        if key == "18a":
            r = WavefrontRenderer.from_buffers(
                sb, RTConfig(flatten=bool(sb.flat)), device=dev)
            step = tiles.make_tiled_wavefront(
                mesh, w, h, p.max_depth, p.spp, shadow=p.shadow,
                pathtrace=p.pathtrace, walk=r.walk)
            args = (r.wa, r.sa, cam_t, light)
        else:
            r = MegakernelRenderer.from_buffers(sb, device=dev)
            step = tiles.make_tiled_renderer(mesh, w, h, p.max_depth)
            args = (r.ta, r.st, cam_t, light)
        out[key] = dict(rays=rays, api_s=api_s, launches=launches,
                        frame_ms=_md_step_ms(step, args, dev),
                        rows=h // mesh.shape["tiles"],
                        host_bytes=host_bytes,
                        img=img if rank == 0 else None)
        del r, step, args
    return out


def md_rank_shards(rank: int, device: str, scene, cam, p, w: int, h: int,
                   n_dp: int, n_sp: int, schedules) -> dict:
    """18c / 18d on one rank: ``render_sharded`` over a (dp, sp) mesh
    with each schedule in turn (launch counts reset before and read
    after, per-ray steps with ``accounting``), its wall time with the
    host build, the bytes gloo moved through host memory."""
    import torch

    from vortex_rt_tpu_torch.parallel import shards
    from vortex_rt_tpu_torch.parallel.mesh import Mesh
    from vortex_rt_tpu_torch.runtime import kernels

    dev = torch.device(device)
    mesh = Mesh.create(("dp", "sp"), (n_dp, n_sp), device=dev)
    out = dict(rank=rank, coords=dict(mesh.coords), backend=mesh.backend)
    for schedule in schedules:
        host0 = mesh.host_bytes
        _sync(dev)
        kernels.reset_launches()
        t0 = time.perf_counter()
        img, rays, steps = shards.render_sharded(
            scene, cam, p, w, h, n_sp, mesh=mesh, schedule=schedule,
            return_steps=True, accounting=True)
        _sync(dev)
        wall_s = time.perf_counter() - t0
        host_bytes = mesh.host_bytes - host0
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        _check(dev.type != "cuda" or launches.get("packet_walk", 0) > 0,
               f"{schedule} rank {rank}: no packet_walk launch "
               f"({launches})")
        out[schedule] = dict(rays=rays, steps=steps, wall_s=wall_s,
                             launches=launches,
                             host_bytes=host_bytes,
                             img=img if rank == 0 else None)
    return out


def _md_compare(label: str, got, rays, ref, ref_rays, rmse_tol=None) -> dict:
    """Image and ray count of a multi-rank frame against one device's."""
    import numpy as np

    diff = float(np.abs(got - ref).max())
    rmse = float(np.sqrt(((got - ref) ** 2).mean()))
    ok = rays == ref_rays and (diff <= IMG_ATOL if rmse_tol is None
                               else rmse < rmse_tol)
    _check(got.shape == ref.shape and ok,
           f"{label}: {rays} vs {ref_rays} rays, image max diff {diff}, "
           f"RMSE {rmse}")
    return dict(max_abs_diff=diff, rmse=rmse)


def phase_multi_device(device, blob_scene, hd=(1920, 1080), size=512
                       ) -> dict:
    """18a-18d (see the module docstring)."""
    from vortex_rt_tpu_torch import (
        RenderParams, RTConfig, Scene, WavefrontRenderer,
    )
    from vortex_rt_tpu_torch.engine.megakernel import MegakernelRenderer
    from vortex_rt_tpu_torch.models.bigscenes import atrium
    from vortex_rt_tpu_torch.parallel import launch, shards

    dev = str(device)
    res = {}
    w, h = hd
    _phase("phase 18a the tiled wavefront frame: ladder config 3 (blob "
           f"n=187, {w}x{h}, spp 4, depth 3, path traced, 8-wide through "
           f"K1) over 2 {MD_RANKS_LABEL}; 18b the tiled megakernel: MK-A's "
           f"scene ({size}x{size}, depth 3) through K6")
    sb3, cfg3 = blob_scene
    cam3 = Scene.framing_camera(sb3, 45.0, w / h)
    p3 = RenderParams(max_depth=3, spp=4, shadow=True, pathtrace=True)
    ref3, rays3 = WavefrontRenderer.from_buffers(sb3, cfg3, device=device
                                                 ).render(cam3, p3, w, h)
    sb_a, _ = config2_scene(sphere_refl=0.6, flatten=False)
    cam_a = config2_camera()
    p_a = RenderParams(light_pos=LIGHT2, max_depth=3, spp=1)
    ref_a, rays_a = MegakernelRenderer.from_buffers(
        sb_a, device=device).render(cam_a, p_a, size, size)
    t0 = time.perf_counter()
    ranks = launch.spawn(md_rank_tiles, 2,
                         (dev, (sb3, cam3, p3, w, h),
                          (sb_a, cam_a, p_a, size, size)))
    spawn_s = time.perf_counter() - t0
    for key, ref, ref_rays, kernel in (
            ("18a", ref3, rays3, "traverse_packet"),
            ("18b", ref_a, rays_a, "traverse2")):
        per = [r[key] for r in ranks]
        _check(all(q["rays"] == per[0]["rays"] for q in per),
               f"{key}: the ranks' totals differ")
        cmp_ = _md_compare(f"{key} 2 ranks", per[0]["img"], per[0]["rays"],
                           ref, ref_rays)
        res[key] = dict(
            ranks=2, rays=per[0]["rays"], **cmp_,
            frame_ms=[q["frame_ms"] for q in per],
            api_s=[q["api_s"] for q in per],
            launches=[q["launches"].get(kernel, 0) for q in per],
            host_bytes=[q["host_bytes"] for q in per],
            rows_per_rank=per[0]["rows"], spawn_s=spawn_s)
        print(f"  {key}: 2 {MD_RANKS_LABEL} (gloo, {ranks[0]['device']}), "
              f"{per[0]['rows']} rows each: the gathered image equals one "
              f"device's render (max diff {cmp_['max_abs_diff']:.3g}), "
              f"{per[0]['rays']} rays both; frame ms per rank "
              f"{[round(x, 3) for x in res[key]['frame_ms']]}, "
              f"{kernel} launches per rank {res[key]['launches']}, host API "
              f"s per rank {[round(x, 2) for x in res[key]['api_s']]}, "
              f"through host memory {res[key]['host_bytes']} B (gloo) (no "
              f"scaling claimed)")
    del ref3, ref_a

    _phase("phase 18c scene shards, replicate: the atrium (29 instances, "
           f"4-wide TLAS through K2), {w}x{h}, spp 1, depth 2, shadow rays, "
           f"at dp=1 x sp=2 and dp=2 x sp=2 ({MD_RANKS_LABEL}); 18d "
           "alltoall at dp=1 x sp=2")
    sc = Scene()
    for mesh_, refl in atrium():
        sc.add_instance(sc.add_mesh(mesh_), reflectivity=refl)
    sb = sc.build(RTConfig())
    cam = Scene.framing_camera(sb, 45.0, w / h, zoom=1.0)
    p = RenderParams(spp=1, max_depth=2, shadow=True)
    rr = WavefrontRenderer.from_buffers(sb, RTConfig(), device=device)
    ref, ref_rays = rr.render(cam, p, w, h)
    tables = {}
    for s in (2, 4):
        t0 = time.perf_counter()
        sharded, sb_full = shards.build_sharded(sc, s)
        tables[s] = dict(shards.memory_table(sharded, sb_full),
                         build_s=time.perf_counter() - t0,
                         instances=[int((sharded.inst_owner == k).sum())
                                    for k in range(s)])
        print(f"  memory_table sp={s}: {tables[s]}")
    del sharded, sb_full
    # dp=1 x sp=2: replicate then alltoall, in one launch
    t0 = time.perf_counter()
    two = launch.spawn(md_rank_shards, 2, (dev, sc, cam, p, w, h, 1, 2,
                                           ("replicate", "alltoall")))
    two_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    four = launch.spawn(md_rank_shards, 4, (dev, sc, cam, p, w, h, 2, 2,
                                            ("replicate",)))
    four_s = time.perf_counter() - t0
    for key, ranks_, sched, spawn_s in (
            ("18c_dp1_sp2", two, "replicate", two_s),
            ("18c_dp2_sp2", four, "replicate", four_s),
            ("18d_dp1_sp2", two, "alltoall", two_s)):
        per = [r[sched] for r in ranks_]
        cmp_ = _md_compare(key, per[0]["img"], per[0]["rays"], ref,
                           ref_rays, rmse_tol=1e-5)
        res[key] = dict(ranks=len(per), rays=per[0]["rays"],
                        steps=per[0]["steps"], **cmp_,
                        wall_s=[q["wall_s"] for q in per],
                        launches=[q["launches"].get("packet_walk", 0)
                                  for q in per],
                        host_bytes=[q["host_bytes"] for q in per],
                        spawn_s=spawn_s)
        print(f"  {key}: {len(per)} {MD_RANKS_LABEL} ({sched}): RMSE "
              f"{cmp_['rmse']:.3g} (max diff {cmp_['max_abs_diff']:.3g}) "
              f"against one device's 4-wide frame, {per[0]['rays']} rays "
              f"both; per-ray walk steps of every rank {per[0]['steps']}; "
              f"K2 launches per rank {res[key]['launches']}; render_sharded "
              f"s per rank (host build included) "
              f"{[round(x, 2) for x in res[key]['wall_s']]}; through host "
              f"memory {res[key]['host_bytes']} B (gloo)")
    a2a, rep = res["18d_dp1_sp2"], res["18c_dp1_sp2"]
    _check(a2a["rays"] == rep["rays"],
           f"18d: alltoall {a2a['rays']} rays, replicate {rep['rays']}")
    _check(a2a["steps"] < rep["steps"],
           f"18d: alltoall's steps {a2a['steps']} not below replicate's "
           f"{rep['steps']}")
    print(f"  18d: alltoall steps / replicate steps = "
          f"{a2a['steps'] / rep['steps']:.4f}; bytes gloo moved through host "
          f"memory per rank {a2a['host_bytes']} (replicate "
          f"{rep['host_bytes']}): gloo runs every collective on CUDA "
          f"tensors itself, so the port stages none")
    res["memory_table"] = tables
    return res


# K1's 8-wide entries as they compiled before the width-16 entries
# existed (commit a133c53), in the default library and in the one built
# with row 6's checker predicate (nvcc 12.8 for sm_90a with the kernels'
# flags; tools/walk_timing.py --parts ptxas on that commit's tree, NVIDIA
# H100 80GB HBM3 at 700.00 W): phase 20a holds this tree's lines to them,
# so the width-16 entries, and the redesign of their internal step, leave
# the main path's kernel as it was
K1_PTXAS_W8 = {
    f"traverse_packet_kernel<{m},{st}>": (
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads | "
        "Used 64 registers, used 0 barriers")
    for m in (0, 1) for st in (0, 1)}
WIDE16_ENTRIES = ("traverse_packet16", "traverse_packet16_alpha",
                  "traverse_packet16_pred", "traverse_packet16_stats")


def k1_ptxas(log: str) -> dict:
    """K1's ptxas lines by kernel entry, named ``traverse_packet_kernel<m,s>``
    or ``traverse_packet16_kernel<m,s>`` (mode, stats)."""
    import re

    from vortex_rt_tpu_torch.tools.walk_timing import _ptxas_entries

    out = {}
    for name, line in _ptxas_entries(log).items():
        m = re.search(r"(traverse_packet(?:16)?_kernel<\d+,\d+>)", name)
        if m:
            out[m.group(1)] = line
    return out


def phase_wide16_build(libs, pred) -> dict:
    """20a: ptxas lines of K1's width-16 entries (the default library's
    and the checker predicate's build) and its 8-wide entries, which must
    equal ``K1_PTXAS_W8``."""
    from vortex_rt_tpu_torch.runtime import kernels

    built = {"default": k1_ptxas(libs["traverse_packet"].build_log),
             "checker": k1_ptxas(kernels.load_pred("traverse_packet",
                                                   pred).build_log)}
    for lib, lines in built.items():
        for name, line in sorted(lines.items()):
            held = name in K1_PTXAS_W8  # (the 8-wide default and alpha ones)
            if held:
                _check(line == K1_PTXAS_W8[name],
                       f"{lib} {name}: ptxas {line!r}, before the width-16 "
                       f"entries {K1_PTXAS_W8[name]!r}")
            print(f"  {lib} {name}: {line}" + ("  (as before)" if held
                                               else ""))
    wide = {k: v for lines in built.values() for k, v in lines.items()
            if "16_kernel" in k}
    _check(len(wide) == 6 and len(built["default"]) == 8
           and len(built["checker"]) == 12,
           f"K1's entries built: {built}")
    return dict(wide16=wide, w8_equal_pr18=True)


def phase_wide16_waves(device, blob_scene, atr_scene, wa8s: dict,
                       reps: int = 10) -> dict:
    """20b: K1 at width 16 on config 3's 1080p primary wave and the five
    waves of a config-4 sample pass, captured from the 16-wide frame: hits
    and steps equal to the plain walk on the card, the counting
    instantiation's internal steps equal to its count, the 8-wide K1's
    hits on the same rays (a difference must be an exact-t tie, H3), both
    widths timed in turns beside their bounds (``k1_timing.
    width_pair_wave``); the plain walk timed on each primary wave."""
    from vortex_rt_tpu_torch import RenderParams, RTConfig, Scene
    from vortex_rt_tpu_torch import WavefrontRenderer
    from vortex_rt_tpu_torch.ops.traverse_packet import (
        kernel_call, trace_packets, trace_packets_ref,
    )
    from vortex_rt_tpu_torch.runtime import kernels
    from vortex_rt_tpu_torch.tools import walk_timing as wt
    from vortex_rt_tpu_torch.tools.k1_timing import width_pair_wave

    counting = wt.w16_build(kernels, {"w16_counts": wt.W16_COUNTS})[
        "w16_counts"]
    out = {}
    for label, (sb, _), spp, n in (("config3", blob_scene, 4, 1),
                                   ("config4", atr_scene, 8, 5)):
        t0 = time.perf_counter()
        r16 = WavefrontRenderer.from_buffers(
            sb, RTConfig(flatten=True, bvh_width=16), device=device)
        tables_s = time.perf_counter() - t0
        _check(r16.wa.width == 16 and r16.wa.fused is not None
               and r16.walk is trace_packets,
               f"{label} at width 16 is not on K1's route")
        r8 = dataclasses.replace(r16, wa=wa8s[label].to(device))
        cam = Scene.framing_camera(sb, 45.0, 1920 / 1080)
        p = RenderParams(max_depth=3, spp=spp, shadow=True, pathtrace=True)
        rec = dict(tables_s=tables_s, depth16=r16.wa.depth,
                   depth8=r8.wa.depth, nodes16=int(r16.wa.nodes.shape[0]),
                   nodes8=int(r8.wa.nodes.shape[0]),
                   fused_bytes16=r16.wa.fused.numel() * 4,
                   fused_bytes8=r8.wa.fused.numel() * 4, waves={})
        waves = capture_waves(r16, cam, p, 1920, 1080, n)
        _check(len(waves) == n, f"{label}: {len(waves)} waves captured")
        for name, (o, d, kw) in zip(PT_WAVES, waves):
            w = width_pair_wave(r16.wa, r8.wa, o, d, kw, reps)
            if name == "closest0":
                w["plain_ms"] = _elapsed_ms(
                    lambda: trace_packets_ref(r16.wa, o, d, **kw), 1, device)
            w["step0"] = s0 = wt.w16_counts(counting[""], wt.w16_through(
                kernels, None, counting,
                lambda: kernel_call(r16.wa, o, d, **kw)))
            rec["waves"][name] = w
            a, b = w["w16"], w["w8"]
            print(f"  {label} {name}: {w['rays']} lanes ({w['live']} live); "
                  f"width 16 {a['ms']:.4f} ms, width 8 {b['ms']:.4f} ms "
                  f"(x{a['ms'] / b['ms']:.3f}); steps a walking ray "
                  f"{a['mean_steps']:.3f} vs {b['mean_steps']:.3f} (internal "
                  f"{a['internal_per_ray']:.3f} vs {b['internal_per_ray']:.3f},"
                  f" leaf {a['leaf_per_ray']:.3f} vs {b['leaf_per_ray']:.3f});"
                  f" bound {a['bound_ms']:.4f} ({a['bound_by']}) = "
                  f"{a['bound_share']:.1%} vs {b['bound_ms']:.4f} = "
                  f"{b['bound_share']:.1%}; hits vs 8-wide "
                  f"{w['hits_vs_8wide']}"
                  + (f"; plain {w['plain_ms']:.1f} ms" if "plain_ms" in w
                     else "")
                  + f"; a lane's internal step (a warp's maximum): children "
                  f"{s0['nch_mean']:.2f} ({s0['nch_warp_max_mean']:.2f}), hit "
                  f"{s0['m_mean']:.2f} ({s0['m_warp_max_mean']:.2f}), a tie "
                  f"{s0['tie_share']:.2%} ({s0['warp_tie_share']:.2%})")
        rec["r16"], rec["r8"], rec["cam"], rec["p"] = r16, r8, cam, p
        print(f"  {label}: tables at width 16 in {tables_s:.2f} s; depth "
              f"{rec['depth16']} (8-wide {rec['depth8']}), {rec['nodes16']} "
              f"nodes ({rec['nodes8']}), fused {rec['fused_bytes16']} B "
              f"({rec['fused_bytes8']})")
        out[label] = rec
    return out


def wide16_frame_pair(label: str, r16, r8, cam, p, w: int, h: int) -> dict:
    """The seed-0 frame at width 16, each of its waves also walked by the
    8-wide K1 (hits equal up to ties: the same triangle distance within
    ``k1_timing.TIE_ULPS`` ulps, H3 and H24, counted), against the 8-wide
    frame: equal rays and the image within ``IMG_ATOL``; where ties were
    counted, at most one pixel off a tie."""
    import numpy as np

    from vortex_rt_tpu_torch.ops.traverse_packet import trace_packets
    from vortex_rt_tpu_torch.tools.k1_timing import tie_split

    ties = []

    def walk(wa, o, d, **kw):
        out = trace_packets(wa, o, d, **kw)
        t = tie_split(out[0], trace_packets(r8.wa, o, d, **kw)[0])
        _check(t["other"] == 0, f"{label}: a wave's hits at width 16 differ "
               f"from width 8's beyond ties: {t}")
        ties.append(t["ties"])
        return out

    img16, rays16 = dataclasses.replace(r16, walk=walk).render(cam, p, w, h)
    img8, rays8 = r8.render(cam, p, w, h)
    diff = float(np.abs(img16 - img8).max())
    off = int((np.abs(img16 - img8).max(-1) > IMG_ATOL).sum())
    _check(np.isfinite(img16).all() and float(img16.std()) > 0.0,
           f"{label}: the 16-wide frame is not a finite, non-constant image")
    if sum(ties) == 0:
        _check(rays16 == rays8 and diff <= IMG_ATOL,
               f"{label}: the 16-wide frame ({rays16} rays) against the "
               f"8-wide ({rays8}): max abs diff {diff}")
    else:
        _check(off <= sum(ties), f"{label}: {off} pixels off the 8-wide "
               f"frame for {sum(ties)} exact-t ties")
    return dict(rays16=int(rays16), rays8=int(rays8), max_abs_diff=diff,
                pixels_off=off, ties=sum(ties), waves=len(ties))


def phase_wide16_frames(device, waves: dict) -> dict:
    """20c: the config-4 frame at width 16 through the entry point, launch
    counts reset before and read after (40 ``traverse_packet16``
    launches, no other walk), both widths' ms a frame in turns, at
    configs 3 and 4; the seed-0 frame against the 8-wide frame
    (``wide16_frame_pair``); then ``perf_trace`` at width 16 (the
    counting instantiation, ``traverse_packet16_stats``) on config 3's
    renderer."""
    from vortex_rt_tpu_torch import RenderParams
    from vortex_rt_tpu_torch.ops import traverse_packet as tp
    from vortex_rt_tpu_torch.runtime import kernels
    from vortex_rt_tpu_torch.tools.k1_timing import device_ms

    w, h = 1920, 1080
    out = {}
    for label in ("config3", "config4"):
        rec = waves[label]
        r16, r8, cam, p = rec["r16"], rec["r8"], rec["cam"], rec["p"]
        for r in (r16, r8):  # warm-up
            r.render_burst(cam, p, w, h, n_frames=1, seed0=100,
                           rays_only=True)
        ms = {16: [], 8: []}
        rays = {16: [], 8: []}
        launches = {}
        for width in (16, 8, 8, 16):
            r = r16 if width == 16 else r8
            _sync(device)
            kernels.reset_launches()
            t0 = time.perf_counter()
            rays[width].append(r.render_burst(cam, p, w, h, n_frames=1,
                                              seed0=200, rays_only=True))
            _sync(device)
            ms[width].append((time.perf_counter() - t0) * 1e3)
            launches[width] = {k: v for k, v in kernels.LAUNCHES.items() if v}
            _check(launches[width] == {
                "traverse_packet16" if width == 16 else "traverse_packet":
                5 * p.spp}, f"{label} at width {width} launched "
                f"{launches[width]}")
        pair = wide16_frame_pair(label, r16, r8, cam, p, w, h)
        out[label] = dict(ms16=ms[16], ms8=ms[8], rays16=rays[16][0],
                          rays8=rays[8][0],
                          k1_16_launches=launches[16]["traverse_packet16"],
                          seed0=pair)
        print(f"  {label} 1920x1080 spp {p.spp} d3 path traced: width 16 "
              f"{ms[16]} ms a frame, width 8 {ms[8]} ms; rays "
              f"{rays[16][0]} / {rays[8][0]}; K1 launches {launches[16]} / "
              f"{launches[8]}; the seed-0 frame against the 8-wide one: "
              f"{json.dumps(pair)}")
    # the counting instantiation on perf_trace's path (config 3, 16-wide)
    r16 = waves["config3"]["r16"]
    kernels.reset_launches()
    st = r16.perf_trace(waves["config3"]["cam"],
                        RenderParams(max_depth=2, shadow=True), 960, 540)
    _sync(device)
    stats_launches = kernels.LAUNCHES["traverse_packet16_stats"]
    _check(stats_launches == 4 and kernels.LAUNCHES["traverse_packet16"] == 0,
           f"perf_trace at width 16 launched {dict(kernels.LAUNCHES)}")
    o, d, kw = capture_waves(waves["config4"]["r16"], waves["config4"]["cam"],
                             waves["config4"]["p"], w, h, 1)[0]
    wa16 = waves["config4"]["r16"].wa
    stats_ms = device_ms(tp.kernel_call(wa16, o, d, stats=True, **kw), 10)
    out["stats"] = dict(launches=stats_launches, rays=int(st["rays"]),
                        int_steps=int(st["trace0"]["int_steps"]),
                        ms=stats_ms,
                        default_ms=device_ms(tp.kernel_call(wa16, o, d, **kw),
                                             10))
    print(f"  perf_trace at width 16 (config 3, 960x540, depth 2): "
          f"{stats_launches} traverse_packet16_stats launches, trace0 "
          f"int_steps {out['stats']['int_steps']}; config 4's primary wave "
          f"{stats_ms:.4f} ms counting, {out['stats']['default_ms']:.4f} ms "
          f"without")
    return out


def phase_wide16_row6(device, sb6, sb6_tlas, cam6, p6, size: int = 512
                      ) -> dict:
    """20d: ladder row 6's scene at width 16, with ``alpha_test_anyhit
    (0.30)`` and with ``stateless_anyhit(checker_pred)``: the 512x512 frame
    through K1's 16-wide alpha and predicate modes (launch counts reset
    before: 8 launches, no K3, no 8-wide walk) against the suspension
    engine's (K3 on the TLAS build, the shader's callable): equal rays,
    images within ``PRED_TOL``; each mode's 512x512 primary wave through
    the bare launch against the plain walk (hits and steps), timed beside
    its bound and the plain walk."""
    import numpy as np

    from vortex_rt_tpu_torch import RTConfig, WavefrontRenderer
    from vortex_rt_tpu_torch.engine.shaders import (
        ShaderTable, alpha_test_anyhit, stateless_anyhit,
    )
    from vortex_rt_tpu_torch.ops import traverse_packet as tp
    from vortex_rt_tpu_torch.ops.anyhit_pred import compile_predicate
    from vortex_rt_tpu_torch.runtime import kernels
    from vortex_rt_tpu_torch.tools import bench_ladder
    from vortex_rt_tpu_torch.tools import walk_bounds as wb
    from vortex_rt_tpu_torch.tools.k1_timing import device_ms, same

    tables = {
        "alpha": ShaderTable(anyhit=alpha_test_anyhit(bench_ladder.ALPHA6)),
        "pred": ShaderTable(anyhit=stateless_anyhit(
            bench_ladder.checker_pred, "checker"))}
    t0 = time.perf_counter()
    r16 = WavefrontRenderer.from_buffers(
        sb6, RTConfig(flatten=True, bvh_width=16), tables["alpha"],
        device=device)
    pool = WavefrontRenderer.from_buffers(
        sb6_tlas, RTConfig(packet_size=0), tables["alpha"], device=device)
    build_s = time.perf_counter() - t0
    out = dict(build_s=build_s, depth16=r16.wa.depth)
    for kind, table in tables.items():
        r = dataclasses.replace(r16, table=table)
        rp = dataclasses.replace(pool, table=table)
        name = f"traverse_packet16_{kind}"
        r.render(cam6, p6, 64, 64)  # warm-up
        kernels.reset_launches()
        t0 = time.perf_counter()
        img, rays = r.render(cam6, p6, size, size)
        _sync(device)
        ms = (time.perf_counter() - t0) * 1e3
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        _check(launches == {name: 8}, f"row 6 + {kind} at width 16 "
               f"launched {launches}")
        img_s, rays_s = rp.render(cam6, p6, size, size)
        err = float(np.abs(img - img_s).max())
        _check(rays == rays_s and np.isfinite(img).all() and err <= PRED_TOL,
               f"row 6 + {kind} at width 16: {rays} rays, the suspension "
               f"engine's {rays_s}; max abs err {err}")
        o, d, kw = capture_waves(r, cam6, p6, size, size, 1)[0]
        walk_kw = dict(kw)
        hk, sk = tp.kernel_call(r.wa, o, d, **walk_kw)()
        _sync(device)
        hp, sp, work = tp.walk_work(r.wa, o, d, **walk_kw)
        _check(same(hk, sk, hp, sp), f"row 6 + {kind}: the 16-wide wave "
               f"differs from the plain walk")
        pred_ops = (wb.pred_ops(compile_predicate(bench_ladder.checker_pred))
                    if kind == "pred" else 0)
        b = wb.k1_bound(work, pred_ops=pred_ops, width=16)
        b0 = wb.k1_bound(work, lookups=False, pred_ops=pred_ops, width=16)
        wave_ms = device_ms(tp.kernel_call(r.wa, o, d, **walk_kw), 10)
        plain_ms = _elapsed_ms(lambda: tp.trace_packets_ref(r.wa, o, d,
                                                            **walk_kw),
                               1, device)
        out[kind] = dict(launches=launches[name], frame_ms=ms, rays=rays,
                         max_abs_err_vs_suspension=err, ms=wave_ms,
                         plain_ms=plain_ms, bound_ms=b.ms,
                         bound_by=b.bound_by, bound_share=b.ms / wave_ms,
                         bound_every_ms=b0.ms,
                         tests=int(work.alpha_tests.sum()),
                         lookups=int(work.alpha_lookups.sum()),
                         mean_steps=float(sp.float().mean()))
        print(f"  row 6 + {kind} at width 16, {size}x{size}: {ms:.3f} ms a "
              f"frame, {rays} rays, {name} launches {launches[name]}, max abs "
              f"err vs the suspension engine {err:.3g}; primary wave "
              f"{wave_ms:.4f} ms (plain {plain_ms:.1f} ms), bound "
              f"{b.ms:.4f} ms ({b.bound_by}) = {b.ms / wave_ms:.1%}, mean "
              f"steps {out[kind]['mean_steps']:.3f}")
    print(f"  row 6's tables at width 16 (with alpha fields) and the "
          f"suspension engine's TLAS in {build_s:.2f} s; depth "
          f"{out['depth16']}")
    return out


def phase_wide16(device, libs, blob_scene, atr_scene, wa8s, sb6, sb6_tlas,
                 cam6, p6) -> dict:
    """20a-20d: K1 at width 16 (``RTConfig(bvh_width=16, flatten=True)``,
    host-built) on ladder configs 3 and 4 and row 6."""
    from vortex_rt_tpu_torch.ops.anyhit_pred import compile_predicate
    from vortex_rt_tpu_torch.tools import bench_ladder

    _phase("phase 20a K1's width-16 entries built; the 8-wide entries' "
           "ptxas lines as before")
    built = phase_wide16_build(
        libs, compile_predicate(bench_ladder.checker_pred))
    _phase("phase 20b K1 at width 16 on config 3's primary wave and config "
           "4's five waves, beside width 8")
    waves = phase_wide16_waves(device, blob_scene, atr_scene, wa8s)
    _phase("phase 20c the config-4 (and config-3) frame at width 16 against "
           "the 8-wide frame")
    frames = phase_wide16_frames(device, waves)
    for rec in waves.values():
        for k in ("r16", "r8", "cam", "p"):
            rec.pop(k)
    _phase("phase 20d row 6 at width 16: alpha and the checker predicate "
           "against the suspension engine")
    row6 = phase_wide16_row6(device, sb6, sb6_tlas, cam6, p6)
    return dict(build=built, waves=waves, frames=frames, row6=row6)


def main() -> int:
    import torch

    # 1. device
    _check(torch.cuda.is_available(), "no CUDA device: this smoke run "
           "needs the GPU and has no CPU path")
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    _check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print("phase 1 device:", torch.cuda.get_device_name(0),
          "torch", torch.__version__, "cuda", torch.version.cuda)
    print(smi.stdout.strip())

    from vortex_rt_tpu_torch.ops.packet_walk import (
        trace_packets_walk, trace_packets_walk_ref,
    )
    from vortex_rt_tpu_torch.ops.traverse_packet import (
        trace_packets, trace_packets_ref,
    )
    from vortex_rt_tpu_torch.runtime import kernels

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    libs = kernels.load_all()
    print(f"phase 2 build: {len(libs)} kernels in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, lib in libs.items():
        print(f"  {lib.path.name}: nvcc {lib.build_seconds:.2f} s")
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print("    " + line.strip())

    _phase("phase 3 K2 vs plain version (64x64 rays)")
    err3 = phase_walk_vs_plain(device, (("flat4", config2_scene(width=4)),
                                        ("tlas", tlas_scene())),
                               trace_packets_walk, trace_packets_walk_ref)
    _phase("phase 4 4-wide frame, K2 vs plain (64x64)")
    phase_small_frame_k2(device)
    _phase("phase 5 K1 vs plain version (64x64 rays, 8-wide fused)")
    err5 = phase_walk_vs_plain(device, (("flat8", config2_scene()),),
                               trace_packets, trace_packets_ref, mixed=True)
    _phase("phase 6 8-wide frame at depth 3, K1 vs plain (64x64)")
    phase_small_frame_k1(device)
    _phase("phase 7 config 2 as bench.py renders it (512x512, 8-wide fused)")
    c2 = phase_config2(device)
    _phase("phase 8 config 2 through the 4-wide route (512x512)")
    c2k2 = phase_config2_k2(device)
    _phase("phase 8b native host builder (csrc/builder.cpp)")
    blob_scene, atr_scene = phase_native_build(device)
    _phase("phase 9 scale scene (blob n=187, 1920x1080, Whitted, 8-wide fused)")
    sc, scale_r = phase_scale(device, blob_scene)
    _phase("phase 9b K1 vs plain version on the scale scene's tree")
    err9 = phase_scale_k1(device, scale_r)
    del scale_r
    _phase("phase 9c ladder config 3's render (blob n=187, host-built; phase "
          "11b renders it from the tree built on the card)")
    c3, r3, cam3, p3 = phase_pathtraced(device, "config 3", blob_scene, 4)
    c3["waves"] = scale_waves(device, r3, cam3, p3, 1920, 1080,
                              names=PT_WAVES, label="config 3")
    # (the 8-wide tables wait on the host for phase 20)
    wa8s = {"config3": r3.wa.to("cpu")}
    del r3
    _phase("phase 9d ladder config 4 (atrium)")
    c4, r4, cam4, p4 = phase_pathtraced(device, "config 4", atr_scene, 8)
    _phase("phase 9e the five waves of one sample pass of config 4")
    c4["waves"] = scale_waves(device, r4, cam4, p4, 1920, 1080,
                              names=PT_WAVES, label="config 4")
    _phase("phase 9f render_accum (config 4's scene)")
    phase_render_accum(device, r4, cam4, p4)
    _phase("phase 9g ladder rows 1 and 4 (row 4 on phase 9d's renderer; row "
           "2 and the bench entry are phase 7's)")
    rows9 = {"row2": c2.pop("row2"), "bench": c2.pop("bench"),
             **phase_ladder_rows(device, r4)}
    wa8s["config4"] = r4.wa.to("cpu")
    del r4
    _phase("phase 10 K7 chained row-fetch probe")
    k7 = phase_k7(device)
    _phase("phase 11a K5: LBVH kernels vs their plain versions")
    lbvh_checked = {k: 0 for k in LBVH_KERNELS}
    lbvh_err = {k: 0.0 for k in LBVH_KERNELS}
    phase_lbvh_kernels(device, lbvh_test_meshes(), lbvh_checked, lbvh_err)
    _phase("phase 11b ladder config 3 on the tree built on the card")
    c3d = phase_config3_device_tree(device, c3, lbvh_checked, lbvh_err)
    _phase("phase 11c ladder config 5 (wavy_grid n=708, refit every frame)")
    c5, st5 = phase_config5(device, lbvh_checked, lbvh_err)
    _phase("phase 12a K4: PLOC kernels vs their plain versions")
    for name in ("ploc_merge", "lbvh_pack", "lbvh_refit", "ploc_collapse",
                 "lbvh_karras", "lbvh_collapse", "lbvh_sah", "traverse_wide"):
        print(f"  {name} (redesigned), ptxas: " + "; ".join(
            line.split("ptxas info    : ")[-1].strip()
            for line in libs[name].build_log.splitlines()
            if "registers" in line or "spill" in line))
    tile = libs["lbvh_refit"].lib.vrt_lbvh_refit_tile()
    print(f"  lbvh_refit: blocks of at most {tile} sorted leaves (treelets of "
          f"at most {tile // 2}), {24 * (2 * tile - 1)} B of dynamic shared "
          f"memory a block (a box a leaf and an inner node)")
    ploc_checked = {k: 0 for k in PLOC_KERNELS}
    ploc_err = {k: 0.0 for k in PLOC_KERNELS}
    phase_ploc_kernels(device, lbvh_test_meshes(), ploc_checked, ploc_err)
    _phase("phase 12b ladder config 3 as the ladder defines it (PLOC tree "
          "built on the card)")
    c3p = phase_config3_ploc(device, c3, ploc_checked, ploc_err)
    _phase("phase 12c PLOC at config 5's mesh (wavy_grid n=708)")
    c5p = phase_config5_ploc(device, st5, ploc_checked, ploc_err)
    _phase("phase 12d the sweep-SAH tree at config 3's mesh (blob n=187)")
    sah3 = phase_sah_config3(device)
    _phase("phase 12e the sweep-SAH tree at config 5's mesh (wavy_grid "
           "n=708)")
    sah5 = phase_sah_config5(device, st5)
    del st5
    _phase("phase 13c ladder row 6 (textured atrium, alpha cutout in K1)")
    row6, sc6, r6, r6_tlas, cam6, p6, table6 = phase_row6(device)
    _phase("phase 13a K3 vs plain version (cutout scene, atrium TLAS crop)")
    k3 = phase_k3(device, r6_tlas, cam6, table6)
    _phase("phase 13b K1 and K2 alpha modes vs plain versions (row 6)")
    alpha = phase_alpha_walks(device, r6, r6_tlas, cam6, c2, sc)
    _phase("phase 13d row 6 parity against the suspension engine (K3), "
           "and the chunked frame")
    par6 = phase_parity6(device, sc6, r6, cam6, p6, table6)
    chunked = phase_chunked(device, r6_tlas, cam6, p6)
    mk = phase_megakernel(device)
    _phase("phase 17a ladder config 3 through the CLI and the OBJ loader "
           "(blob n=187 written to an OBJ, 1920x1080, spp 4, depth 3)")
    cli3 = phase_cli_config3(device)
    _phase("phase 17b the CLI's --perf on the card: per-wave statistics "
           "through K1's and K2's counting instantiations")
    perf17 = phase_cli_perf(device, r6, r6_tlas, cam6)
    sb6, sb6_tlas = r6.sb, r6_tlas.sb  # (host tables; phase 19's scene)
    del r6, r6_tlas
    _phase("phase 17c the CLI's --scope-out and frame_profile")
    scope17 = phase_cli_scope(device)
    _phase("phase 17d the CLI's --compare, and MK-B through the CLI")
    cmp17 = phase_cli_compare(device)
    _phase("phase 17e the RT-unit facade and the device API (the atrium's "
           "4-wide TLAS, 512x512)")
    rtu17 = phase_rtu(device, mk.pop("atrium_tlas"))
    md = phase_multi_device(device, blob_scene)
    pred19 = phase_pred(device, sc6, sb6, sb6_tlas, cam6, p6)
    w16 = phase_wide16(device, libs, blob_scene, atr_scene, wa8s, sb6,
                       sb6_tlas, cam6, p6)
    del sb6, sb6_tlas, wa8s
    _phase("phase 16 results")
    print(f"  summary: config2 {c2['mrays']:.3f} Mrays/s, scale "
          f"{sc['mrays']:.3f} Mrays/s, peak {sc['peak_bytes']} B; config 3 "
          f"{c3['frame_ms']:.3f} ms/frame {c3['mrays']:.3f} Mrays/s, config "
          f"4 {c4['frame_ms']:.3f} ms/frame {c4['mrays']:.3f} Mrays/s, peak "
          f"{c4['peak_bytes']} B")

    print("  ladder: " + "; ".join(
        f"{k} {v['ms_per_frame']:.3f} ms/frame {v['mrays']:.3f} Mrays/s "
        f"parity RMSE {v['parity_rmse']:.3g}"
        for k, v in rows9.items() if k != "bench")
        + f"; bench entry {rows9['bench']['value']:.3f} Mrays/s")
    print(f"  config 3 on the device-built tree "
          f"{c3d['ms_per_frame']:.3f} ms/frame (build "
          f"{c3d['lbvh_build_ms']:.4f} ms); config 5 "
          f"{c5['ms_per_frame']:.3f} ms/frame + refit {c5['refit_ms']:.4f} "
          f"ms, build {c5['lbvh_build_ms']:.4f} ms, peak "
          f"{c5['peak_bytes']} B")
    print(f"  config 3 on the PLOC tree {c3p['ms_per_frame']:.3f} ms/frame "
          f"(build {c3p['lbvh_build_ms']:.4f} ms, {c3p['ploc_rounds']} "
          f"rounds, depth {c3p['tree_depth']}); PLOC at config 5's mesh: "
          f"build {c5p['build_ms']:.4f} ms, {c5p['rounds']} rounds, depth "
          f"{c5p['tree_depth']}, refit {c5p['refit_ms']:.4f} ms")

    # 13. results.  K1's launches are config 4's frame; the other paths'
    # counts stand beside it.  The LBVH kernels' are config 5's run
    c2.update(launches=c4["k1_launches"],
              launches_per_frame=c4["k1_launches"], launches_by_path={
        "config2": c2["launches"], "config3": c3["k1_launches"],
        "config4": c4["k1_launches"],
        "config3_device_tree": c3d["launches"]["traverse_packet"],
        "config5": c5["launches_k1"], "cli_config3": cli3["k1_launches"],
        **{f"ladder_{k}": v["launches"] for k, v in rows9.items()},
        "tiled_wavefront_per_rank": md["18a"]["launches"]})
    for name in LBVH_KERNELS:
        _check(lbvh_checked[name] > 0, f"phases 11a-11c checked no {name}")
        c5["kernels"][name]["launches_by_path"]["config3_device_tree"] = \
            c3d["launches"][name]
    rows = []
    c2k2["launches_by_path"] = {
        "config2_4wide": c2k2["launches"],
        **{f"sharded_{k}_per_rank": md[k]["launches"]
           for k in ("18c_dp1_sp2", "18c_dp2_sp2", "18d_dp1_sp2")}}
    c2k2["other_waves"] = {"atrium_tlas_1080p": {
        k: mk["k2_hd"].get(k) for k in ("ms", "plain_ms_crop", "bound_ms",
                                        "bound_by", "rays", "mean_steps")}}
    for name, res, err in (
            ("packet_walk", c2k2, max(err3, c2k2["max_abs_err"],
                                      mk["k2_hd"]["max_abs_err"])),
            ("traverse_packet", c2, max(err5, err9, c5["walk_err"],
                                        c2["max_abs_err"])),
            ("hbm_walk", k7, k7["max_abs_err"]),
            # the largest word difference phases 11a-11c measured
            *((name, c5["kernels"][name], lbvh_err[name])
              for name in LBVH_KERNELS)):
        src, replaces = SOURCES[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": res["launches"],
                     "launches_per_frame": res["launches_per_frame"],
                     "launches_by_path": res.get("launches_by_path"),
                     "max_abs_err": err,
                     "ms": res["ms"], "plain_ms": res["plain_ms"],
                     "bound_ms": res["bound_ms"],
                     "bound_by": res["bound_by"],
                     "bound_share": res["bound_ms"] / res["ms"],
                     "library_ms": None,
                     # every ms is by CUDA events: around the bare launch
                     # for the walks, around the wrapper for the LBVH rows
                     "ms_source": ("cuda_events_wrapper" if "kernel_ms" in res
                                   else "cuda_events_launch"),
                     **{k: res[k] for k in ("kernel_ms", "other_waves")
                        if k in res}})
    # the K4 rows: launches and times on row 3's path (config 3, T 69,940;
    # six builds: a warm-up and five timed), config 5's beside them
    for name in PLOC_KERNELS:
        _check(ploc_checked[name] > 0, f"phases 12a-12c checked no {name}")
        t3, t5 = c3p["times"][name], c5p["times"][name]
        src, replaces = SOURCES[name]
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "launches": c3p["launches"][name],
               "kernels": list(PLOC_KERNEL_NAMES[name]),
               "launches_per_frame": None,
               "launches_by_path": {
                   "config3_ploc": c3p["launches"][name],
                   "config5_ploc_build": c5p["build_launches"][name],
                   "config5_ploc_refit_per_frame":
                       c5p["refit_launches"][name]},
               "max_abs_err": ploc_err[name], "ms": t3["ms"],
               "plain_ms": t3["plain_ms"], "bound_ms": t3["bound_ms"],
               "bound_by": t3["bound_by"],
               "bound_share": t3["bound_ms"] / t3["ms"], "library_ms": None,
               "ms_source": "cuda_events_wrapper",
               "kernel_ms": t3["kernel_ms"],
               "config5": {k: t5[k] for k in ("ms", "plain_ms", "bound_ms",
                                              "kernel_ms")}}
        if name == "ploc_refit":
            keys = ("ms", "plain_ms", "bound_ms", "kernel_ms", "device_ops")
            row["refit_climb"] = {
                "config3": {k: c3p["times"]["ploc_refit_climb"].get(k)
                            for k in keys},
                "config5": {k: c5p["times"]["ploc_refit_climb"].get(k)
                            for k in keys}}
        rows.append(row)
    # the any-hit path: K3's launches are the parity frame's (13d), the
    # alpha modes' the row-6 frames' (13c)
    for name, res, launches, per_frame in (
            ("traverse_wide", k3, par6["launches"], par6["launches"]),
            ("traverse_packet_alpha", alpha["traverse_packet_alpha"],
             row6["k1_alpha_launches"], row6["k1_alpha_launches_per_frame"]),
            ("packet_walk_alpha", alpha["packet_walk_alpha"],
             row6["k2_alpha_launches"], row6["k2_alpha_launches"])):
        src, replaces = SOURCES[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches,
                     "launches_per_frame": per_frame,
                     "launches_by_path": ({"parity6": launches,
                                           "chunked": chunked["launches"],
                                           "rtu": rtu17["k3_launches"]}
                                          if name == "traverse_wide"
                                          else None),
                     "max_abs_err": (max(res["max_abs_err"],
                                         chunked["max_abs_err"])
                                     if name == "traverse_wide"
                                     else res["max_abs_err"]),
                     "ms": res["ms"],
                     "plain_ms": res["plain_ms"],
                     "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
                     "bound_share": res["bound_ms"] / res["ms"],
                     "library_ms": None,
                     "ms_source": res.get("ms_source", "cuda_events_launch"),
                     **{k: res[k] for k in (
                         "no_alpha_ms", "events_ms", "bound_every_lane_ms",
                         "blocks_per_sm", "bound_every_ms", "alpha_tests",
                         "alpha_lookups") if k in res}})
    print(f"  row 6: {row6['ms_per_frame']:.3f} ms/frame at 512x512 "
          f"({row6['mrays']:.3f} Mrays/s), {row6['ms_per_frame_hd']:.3f} "
          f"ms/frame at 1080p ({row6['mrays_hd']:.3f} Mrays/s), peak "
          f"{row6['peak_bytes']} B; parity RMSE {par6['parity_rmse']:.3g} "
          f"with {par6['k3_launches']} K3 launches; chunked frame "
          f"{chunked['launches']} K3 launches")
    # K6: launches are MK-A's timed frames' (12 a frame), MK-B's beside
    # them; its time by CUDA events around the launch on MK-A's primary
    # wave
    t6 = mk["times"]["mk_a_primary"]
    src, replaces = SOURCES["traverse2"]
    rows.append({"name": "traverse2", "route": "cuda", "source": src,
                 "replaces": replaces,
                 "launches": mk["mk_a"]["k6_launches"],
                 "launches_per_frame": mk["mk_a"]["k6_launches_per_frame"],
                 "launches_by_path": {
                     "mk_a": mk["mk_a"]["k6_launches"],
                     "mk_b": mk["mk_b"]["k6_launches"],
                     "tiled_megakernel_per_rank": md["18b"]["launches"]},
                 "max_abs_err": mk["max_abs_err"], "ms": t6["ms"],
                 "plain_ms": t6["plain_ms"], "bound_ms": t6["bound_ms"],
                 "bound_by": t6["bound_by"],
                 "bound_share": t6["bound_ms"] / t6["ms"],
                 # no one PyTorch call walks a BVH
                 "library_ms": None, "ms_source": "cuda_events_launch",
                 "profiler_ms": t6["profiler_ms"],
                 "profiler_launches": t6["profiler_launches"],
                 "fetch_bytes": t6["fetch_bytes"],
                 "other_waves": {k: {f: v[f] for f in (
                     "ms", "profiler_ms", "profiler_launches", "plain_ms",
                     "bound_ms", "rays", "fetch_bytes")}
                     for k, v in mk["times"].items() if k != "mk_a_primary"}})
    # the sweep-SAH tree: launches of one build at config 3's mesh (one
    # cooperative launch); its time the whole sweep's by CUDA events, the
    # kernel's by the profiler beside; config 5's mesh beside
    src, replaces = SOURCES["lbvh_sah"]
    rows.append({"name": "lbvh_sah", "route": "cuda", "source": src,
                 "replaces": replaces, "launches": sah3["launches"],
                 "kernels": list(SAH_KERNEL_NAMES),
                 "launches_per_frame": None,
                 "launches_by_path": {"config3_sah_build": sah3["launches"],
                                      "config5_sah_build": sah5["launches"]},
                 "max_abs_err": max(sah3["max_abs_err"], sah5["max_abs_err"]),
                 "ms": sah3["ms"], "plain_ms": sah3["plain_ms"],
                 "bound_ms": sah3["bound_ms"], "bound_by": sah3["bound_by"],
                 "bound_share": sah3["bound_ms"] / sah3["ms"],
                 # no one PyTorch call builds a tree
                 "library_ms": None, "ms_source": "cuda_events_wrapper",
                 "kernel_ms": sah3["kernel_ms"],
                 "levels": sah3["levels"],
                 "host_reads": sah3["host_reads"],
                 "device_ops": sah3["device_ops"],
                 "bound_every_position_ms": sah3["bound_every_position_ms"],
                 "config5": {k: sah5[k] for k in (
                     "ms", "plain_ms", "bound_ms", "kernel_ms", "levels",
                     "build_ms", "host_reads", "device_ops",
                     "bound_every_position_ms")}})
    print(f"  megakernel: MK-A {mk['mk_a']['ms_per_frame']:.3f} ms/frame "
          f"{mk['mk_a']['mrays']:.3f} Mrays/s {mk['mk_a']['rays_per_frame']} "
          f"rays, peak {mk['mk_a'].get('peak_bytes')} B; MK-B "
          f"{mk['mk_b']['ms_per_frame']:.3f} ms/frame "
          f"{mk['mk_b']['mrays']:.3f} Mrays/s {mk['mk_b']['rays_per_frame']} "
          f"rays, peak {mk['mk_b'].get('peak_bytes')} B; sweep-SAH builds "
          f"{sah3['build_ms']:.4f} ms ({sah3['levels']} levels, wide depth "
          f"{sah3['wide_depth']}) and {sah5['build_ms']:.4f} ms "
          f"({sah5['levels']} levels, wide depth {sah5['wide_depth']})")
    # the counting instantiations of K1 and K2: times on the primary wave
    # of the CLI's config-2 frame (cornell, 512x512), the default
    # instantiation's beside; bound the walk's
    for name, key, by_path in (
            ("traverse_packet_stats", "k1", {
                "cli_perf": perf17["cli_launches"],
                "perf_trace_8wide": perf17["k1"]["launches"][
                    "traverse_packet_stats"]}),
            ("packet_walk_stats", "k2", {
                "perf_trace_4wide": perf17["k2"]["launches"][
                    "packet_walk_stats"]})):
        w0 = perf17[key]["waves"]["trace0"]
        src, replaces = SOURCES[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces,
                     "launches": sum(by_path.values()),
                     "launches_per_frame": 4,
                     "launches_by_path": by_path,
                     "max_abs_err": perf17["max_abs_err"],
                     "ms": w0["stats"]["ms"],
                     "default_ms": w0["default"]["ms"],
                     "profiler_ms": w0["stats"]["profiler_ms"],
                     "default_profiler_ms": w0["default"]["profiler_ms"],
                     "plain_ms": w0["plain_ms"], "bound_ms": w0["bound_ms"],
                     "bound_by": w0["bound_by"],
                     "bound_share": w0["bound_ms"] / w0["stats"]["ms"],
                     # counters of a walk: no one PyTorch call walks a BVH
                     "library_ms": None, "ms_source": "cuda_events_launch",
                     "other_waves": {k: {f: v.get(f) for f in (
                         "default", "stats", "live")}
                         for k, v in perf17[key]["waves"].items()
                         if k != "trace0"}})
    # the predicate modes of K1 and K2: launches on 19c's frames (K1's six
    # row-6 frames, K2's TLAS frame), time on row 6's 512x512 primary wave
    perf = pred19["perforated"]
    for name, launches, per_frame in (
            ("traverse_packet_pred", pred19["frames"]["k1_pred_launches"],
             pred19["frames"]["k1_pred_launches_per_frame"]),
            ("packet_walk_pred", pred19["frames"]["k2_pred_launches"],
             pred19["frames"]["k2_pred_launches"])):
        res = pred19["walks"][name]
        src, replaces = SOURCES[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches,
                     "launches_per_frame": per_frame,
                     "launches_by_path": (
                         {"row6_pred": launches,
                          "parity6_pred": pred19["parity"]["k1_launches"]}
                         if name == "traverse_packet_pred" else
                         {"row6_pred_tlas": launches}),
                     "max_abs_err": res["max_abs_err"], "ms": res["ms"],
                     "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                     "bound_by": res["bound_by"],
                     "bound_share": res["bound_ms"] / res["ms"],
                     # no one PyTorch call walks a BVH
                     "library_ms": None, "ms_source": "cuda_events_launch",
                     "alpha_ms": res["alpha_ms"],
                     "no_anyhit_ms": res["no_anyhit_ms"],
                     "all_test_ms": res["all_test_ms"],
                     "bound_every_ms": res["bound_every_ms"],
                     "class_share": res["class_share"],
                     "pred_tests": res["pred_tests"],
                     "pred_ops": pred19["build"]["n_ops"],
                     "pred_digest": pred19["build"]["digest"],
                     "nvcc_s": pred19["build"]["build_s"][
                         name.rsplit("_", 1)[0]],
                     "other_waves": res["other_waves"],
                     # 19e: the same waves with the perforated predicate
                     "perforated": {
                         **{k: perf["walks"][name].get(k) for k in (
                             "ms", "plain_ms", "bound_ms", "bound_by",
                             "bound_every_ms", "all_test_ms", "alpha_ms",
                             "class_share", "pred_tests", "other_waves")},
                         "launches": perf["frames"][
                             "k1_pred_launches" if name ==
                             "traverse_packet_pred" else "k2_pred_launches"],
                         "pred_ops": perf["build"]["pred_ops"],
                         "ptxas": perf["build"]["ptxas"][
                             name.rsplit("_", 1)[0]],
                         "nvcc_s": perf["build"]["build_s"][
                             name.rsplit("_", 1)[0]]}})
    # K1's width-16 entries: the plain walk's launches on the config-4
    # frame at width 16 (20c), the alpha and predicate modes' on row 6's
    # 16-wide frames (20d), the counting one's on perf_trace (20c); times
    # on config 4's primary wave (the modes': row 6's 512x512 primary
    # wave, the 8-wide mode's time of 13b / 19b beside)
    c4w = w16["waves"]["config4"]["waves"]["closest0"]
    for name, mode, res, launches, extra in (
            ("traverse_packet16", "0,0", dict(
                c4w["w16"], plain_ms=c4w["plain_ms"]),
             w16["frames"]["config4"]["k1_16_launches"], dict(
                 w8_ms=c4w["w8"]["ms"], w8_bound_ms=c4w["w8"]["bound_ms"],
                 waves={f"{cfg}/{k}": {"w16_ms": v["w16"]["ms"],
                                       "w8_ms": v["w8"]["ms"],
                                       **{f: v["step0"][f] for f in (
                                           "nch_mean", "m_mean",
                                           "m_warp_max_mean",
                                           "tie_share")}}
                        for cfg in ("config3", "config4")
                        for k, v in w16["waves"][cfg]["waves"].items()})),
            ("traverse_packet16_alpha", "1,0", w16["row6"]["alpha"],
             w16["row6"]["alpha"]["launches"],
             dict(w8_ms=alpha["traverse_packet_alpha"]["ms"])),
            ("traverse_packet16_pred", "2,0", w16["row6"]["pred"],
             w16["row6"]["pred"]["launches"],
             dict(w8_ms=pred19["walks"]["traverse_packet_pred"]["ms"])),
            ("traverse_packet16_stats", "0,1", dict(
                c4w["w16"], ms=w16["frames"]["stats"]["ms"],
                plain_ms=c4w["plain_ms"]),
             w16["frames"]["stats"]["launches"], dict(
                 default_ms=w16["frames"]["stats"]["default_ms"]))):
        src, replaces = SOURCES[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches,
                     "launches_per_frame": launches,
                     # 20b and 20d hold every wave to the plain walk to
                     # the bit (they raise on any difference)
                     "max_abs_err": 0.0,
                     "ms": res["ms"], "plain_ms": res["plain_ms"],
                     "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
                     "bound_share": res["bound_ms"] / res["ms"],
                     # no one PyTorch call walks a BVH
                     "library_ms": None, "ms_source": "cuda_events_launch",
                     "ptxas": w16["build"]["wide16"][
                         f"traverse_packet16_kernel<{mode}>"],
                     **extra})
    print(f"  K1 at width 16: config 4 {w16['frames']['config4']['ms16']} ms "
          f"a frame (8-wide {w16['frames']['config4']['ms8']}), config 3 "
          f"{w16['frames']['config3']['ms16']} "
          f"({w16['frames']['config3']['ms8']}); primary wave "
          f"{c4w['w16']['ms']:.4f} ms (8-wide {c4w['w8']['ms']:.4f})")
    print(f"  row 6 with the checker predicate: "
          f"{pred19['frames']['ms_per_frame']:.3f} ms/frame at 512x512, "
          f"{pred19['frames']['ms_per_frame_hd']:.3f} at 1080p (K1), TLAS "
          f"{pred19['frames']['tlas_frame_ms']:.3f} ms (K2); parity max abs "
          f"{pred19['parity']['parity_max_abs']:.3g}, "
          f"{pred19['parity']['k3_launches']} K3 launches")
    print(f"  CLI: config 3 from an OBJ {cli3['frame_ms']:.3f} ms/frame "
          f"({cli3['mrays']:.3f} Mrays/s; the CLI's own reading "
          f"{cli3['cli_ms']:.1f} ms with its table build), OBJ load "
          f"{cli3['obj_load_s']:.3f} s; MK-B through the CLI "
          f"{cmp17['mk_b_cli_ms']:.1f} ms; RT unit "
          f"{rtu17['rays_per_s'] / 1e6:.3f} Mrays/s, {rtu17['rounds']} "
          f"rounds, {rtu17['k3_launches']} K3 launches; scope stages "
          f"{scope17['scope_ms']}")
    print("  multi-device (" + MD_RANKS_LABEL + "; no scaling claimed): "
          + json.dumps(_json_safe({k: {f: v for f, v in r.items()
                                       if f != "img"}
                                   for k, r in md.items()})))
    print(json.dumps(_json_safe({"kernels": rows})))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
