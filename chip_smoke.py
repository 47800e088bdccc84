#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own line; any failure raises and the script
exits non-zero:

1. the card: ``torch.cuda.is_available()`` or exit 1; ``nvidia-smi`` name
   and power limit;
2. build every CUDA kernel from ``video_edge_ai_proxy_tpu_torch/csrc``
   (one ``nvcc`` per source, all started together), with each kernel
   instantiation's registers and spills; the SASS of the three tensor-core
   libraries (the bf16 forward, dq and dk/dv) must hold ``HGMMA``
   instructions in every kernel, and none of their kernels may spill; the
   keep-mask kernel's registers, shared memory and cluster size, and it
   may not spill either;
3. each kernel against its plain PyTorch version on the card: the NMS
   keep mask bit-identical (random boxes with duplicates, zero-area boxes,
   all-zero slots and class-offset boxes, B = 16, K = 256 and K = 1024;
   and its edges: K = 1, 64, 65 and 1024 at B = 1, 16 and 40, each at
   t = 0, 0.45, 0.7 and -0.1, with and without NaN and infinite
   coordinates; and a chain of boxes each overlapping only its
   neighbours, where greedy keeps every other box);
   the flash-attention forward's O and LSE, and the two backward kernels'
   dq and dk/dv, in float32 and bf16 at BH = 24, T = 6272, D = 64, at a
   padded T = 200, and at D = 16 and 32; the profiler shows that bf16
   forward, dq and dk/dv calls ran the tensor-core kernels and float32
   calls the float32 ones;
4. the detection slice at full width: ``yolov8n`` at 640 in bf16 with
   seeded random weights and the zeroed class prior, on 16x1080x1920
   uint8 frames with ``quality_thumb=32`` -- shapes, finiteness,
   ``valid.sum() > 0``, the same detections with the plain keep mask
   swapped in, float32 agreement of the model and preprocessing with the
   CPU on two frames, step time (median of 20), the keep-mask kernel's own
   time on the step's candidates (profiler and CUDA events) beside its
   bound and, as a note, the floor of its dependent K-step chain and of a
   launch, and the kernel's device time per added candidate at B = 1 from
   K = 64 to 256 and 1024, peak memory, and a profile of where a step's device time goes;
5. the engine answers detection requests: ``InferenceEngine(device="cuda")``
   over a ``MemoryFrameBus`` of 16 streams at 1080p; every stream must
   get results;
6. the video slice at full width: ``videomae_b_long`` (64-frame clips,
   6272 tokens) in bf16 with seeded random weights on 2 streams' clips of
   64x1080x1920 uint8 -- shapes, finiteness, exactly 12 flash-kernel
   launches per step, the same logits with the plain attention swapped
   in, float32 agreement with the CPU on one clip (2 of 12 layers, to
   save CPU time), step time (median of 10), peak memory, the kernel's
   own time on the step's q, k, v beside the plain version, the library's
   ``scaled_dot_product_attention`` and the bound (with the share of the
   bound and the TFLOP/s of the function's operations), and a profile of
   the step;
7. ``vit_b16`` beside it: the bf16 step on 32 1080p frames (shapes,
   finiteness) and float32 agreement with the CPU on two frames;
8. the engine answers video requests: ``InferenceEngine(device="cuda")``
   serving ``videomae_b_long`` over 2 streams at 1080p, fed one frame per
   stream per tick until every stream has 2 results;
9. the training slice at full width: ``make_trainer`` fine-tuning
   ``videomae_b_long`` (float32 parameters, bf16 compute) on 2 clips
   preprocessed from 64x1080x1920 uint8 for 5 steps -- finite losses,
   exactly 12 forward, 12 dq and 12 dk/dv launches per step, the same
   gradients with the plain forward and backward swapped in, float32
   gradients on the card against the CPU on a cut configuration (one
   16-frame clip, 1568 tokens, 2 layers), step time (median), peak memory,
   a profile of the step, each backward kernel's own time on the step's
   inputs beside its plain version, the library's backward of
   ``scaled_dot_product_attention`` and the bound (with the share of the
   bound and the TFLOP/s of the function's operations), and one serving step of
   the registry's bf16 model with the trained weights;
10. two VideoMAE pretraining steps of ``videomae_b_long``
   (``masked_pretrain_loss``, a 90% tube mask): finite losses and 16
   launches of each flash kernel per step (12 encoder + 4 decoder layers);
11. the default engine's serving pipeline on ``yolov8n`` bf16 with
   ``quality_thumb=32`` at 16x1080p: (a) a synthetic trace of 16 streams,
   8 frames each, replayed twice through ``lockstep_checksum`` (the two
   folds bit-identical, a perturbed weight moves the fold); (b) the same
   frames through the engine's collector and dispatch with the transfer
   and drain threads, and synchronously: the same result checksum, bit
   for bit; (c) 16 streams published at 30 fps for 20 s on distinct
   frames through ``InferenceEngine(bus, EngineConfig())``: every stream
   served, every detection with a track id, the ladder back at
   ``normal``; capture->result latency p50/p95/p99 against the 40 ms
   limit, frames/s, the shed share, the H2D time overlapped with compute,
   the step spans against wall time and the drain's host time per frame
   are reported, not gated; the traffic is the repo's detection traffic
   (class prior zeroed); (d) the step's synchronising operations by
   source line (``torch.cuda.set_sync_debug_mode``): there must be none;
   then (c)'s traffic with ``slo_warmup_s`` cut to 3 s and every bucket's
   program prewarmed, for 12 s: its blocking CUDA runtime calls, launches
   and device copies per batch over the first 3 s (torch.profiler), and
   the SLO verdict: the fps objective (1000 frames/s, above the 480
   offered) must fire and the ladder end at ``admission_pause``, and the
   admitted streams must still be served;
12. the engine's compiled step, one CUDA graph per (model, stem, geometry,
   bucket) key: (a) the ``yolov8n`` detection step at 16x1080p with
   ``quality_thumb=32`` as the engine captures it (``_GraphedStep``)
   against the eager ``build_serving_step``: three distinct inputs
   replayed back to back with every output held until the last has run,
   each bit-identical to eager; no synchronising operation in a replay
   nor in the eager step; the capture's seconds, the graph pool's bytes
   and the peak memory beside the eager step's; the replay's and the
   eager step's medians of 20 (wall and CUDA events); host runtime calls
   per call and the device kernels of one replay (the keep-mask kernel
   among them), and the keep mask's device time inside a replay; (b) the
   same for the ``videomae_b_long`` step on 2 clips (the flash forward
   among the replay's kernels); (c) prewarm: an engine with
   ``prewarm=[[1080, 1920, 16]]`` and the prewarm manifest on a temporary
   directory is complete after ``start()`` and serves its first batch as
   a step-cache hit, and a second engine on the same directory with no
   ``prewarm`` prewarms the same program from the manifest;
13. the deployment's frame path: (a) 11a's trace through
   ``lockstep_checksum`` and the engine's ``serve_lockstep`` over a
   ``ShmFrameBus`` in a fresh ring directory, folding 11a's and 11b's
   integers of the same run; (b) 16 ``python -m
   video_edge_ai_proxy_tpu_torch.ingest.worker`` processes, one per camera,
   on the environment contract (``test://`` 1080p at 30 fps, a ring of 2
   slots each), read by ``InferenceEngine(open_bus("shm", dir),
   EngineConfig())`` with one subscriber over all 16 for 20 s: frames/s,
   latency p50/p95/p99 and stages, frames superseded, each worker's
   published and decoded counts from its heartbeat, beside 11c's numbers;
   gated: every stream served, every detection with a track id, no "engine
   tick failed" or "drain failed" record on the engine's logger, every
   worker exits 0 at SIGTERM, no worker initialises CUDA or maps the CUDA
   driver (``nvidia-smi --query-compute-apps`` is printed); (c) 2 worker
   processes with ``active_window_s`` cut to 2 s and a subscriber for one
   stream: the other stops being inferred after its linger, its worker
   falls back to keyframes (fps/gop frames a second), and a subscriber
   for it brings it back within one tick; (d) three injected collect
   failures are logged and results flow; a capture that fails for one
   geometry (720p, which sorts first) retires its graph pool, and while
   both geometries are published in the same ticks 1080p captures and is
   served, the failed key is never captured again (two pools, their bytes
   flat) and none of its batches is run eagerly or served. 11c and 13b
   print how late a 5 ms sleep wakes in a process of its own (a core)
   and in a thread of the engine's process (a core and the interpreter
   lock) beside the threads' CPU time. The ring directory of each
   part is chosen openly: the /dev/shm tmpfs when it has room for the
   rings, else the temporary directory, and the script says which and why;
14. the default ``Server``'s planes around the engine: a ``Server`` built
   from ``Config()`` (its ring directory, the annotation and API endpoints
   pointed at a local HTTP sink, ``slo_warmup_s`` 3 s) with the engine on
   the card, driven in ``start()``'s order without the wire (registry
   resume, cron, the annotation consumer, the engine); 16 cameras
   registered through its process
   manager (``test://`` 1080p at 30 fps, 14 on yolov8n, one of them with the
   keyframe annotation policy, one on vit_b16, one with inference off), one
   subscriber for 20 s: frames/s and p50/p95/p99 per model beside 13b's,
   results per camera, each worker's decoded frames a second, the graph
   keys, the ladder, the workers' limits and cores, the annotation events
   the sink got (signed, per stream and type) and the queue's shed count;
   then one worker SIGKILLed (respawned with failing_streak 1 and the OOM
   flag, its results back), ``Server.stop()`` (workers detached) and a new
   ``Server`` on the same data dir whose resume re-adopts them (pid and
   birth tick), started with the whole ``Server.start()`` when this machine
   has ``grpcio``, ``protobuf`` and ``aiohttp`` (the script prints which it
   has): REST and gRPC on ephemeral ports, checked through gRPC
   ListStreams, Inference, VideoLatestImage and Annotate and REST
   /healthz, /api/v1/stats and /metrics; served 10 s more, then its
   workers shut down. Gated: every
   camera but the one switched off served, that one never; vit_b16's
   results are top-5 without boxes; every yolov8n detection tracked; events
   offered to the uplink from every yolov8n camera (accepted or shed at
   the queue's limit) and none from the one switched off, the sink's
   events as many as the queue acked, every POST signed, the keyframe
   camera's events from keyframes only; the
   killed worker back; every yolov8n camera served after the resume; the
   wire's answers where it ran; no worker on the card; no logged tick or
   drain failure. The audit and profiling planes, on by default: the
   first window prints ``_watch_tick``'s cost a tick (mean and p99 µs,
   timed from the script) and the journal's events a second; the second
   server samples lineage spans (``obs.trace``, 1 in 16: a departure from
   the shipped config) and, while its cameras are served, takes a
   torch.profiler capture of 500 ms over REST, one of 300 ms over gRPC
   ``vep.Admin/ProfileCapture`` and two of 500 ms at once over REST, then
   reads ``/api/v1/journal``, ``/api/v1/why?subject=ladder:engine`` and
   ``/api/v1/trace``. Gated: every bundle's manifest without an error,
   its device trace found and parsed with ``nms_keep_mask_kernel``
   events among its CUDA kernels (printed beside the batches stepped and
   the keep-mask launches during the call), its spans and journal files;
   one 409 of the two at once; an ``escalate`` link in the ladder's chain
   (whether it roots at an SLO ``episode_open`` is printed); a complete
   lineage. Printed too: each capture's wall time against its length
   (the first pays CUPTI's start), results/s inside its window beside the
   same length before, the stage legs' p50/p95, and any worker respawned
   while the captures ran;
15. the detection step's variants and the device accounting, on the
   engine at 16x1080p with ``yolov8n``'s seeded weights (class prior
   zeroed): (a) the fused letterbox's folded plane within ``FUSED_TOL``
   (2/255) of ``space_to_depth(preprocess_letterbox(...))`` in bf16; (b)
   the s2d fold in float32 eager on 4 frames: boxes and logits within
   ``FOLD_BOX_TOL_PX`` (1e-3) of the classic model's, classes equal; (c)
   ``classic``, ``s2d``, ``int8``, ``s2d`` + ``int8`` and ``int8_act``,
   each an engine (``EngineConfig(stem=..., quantize=..., hbm=True)``)
   handed the classic weights: ``compile_for`` captures its program, the
   replay bit-identical to the eager step of the same key, then 2 batches
   of 16 served through ``serve_lockstep`` with the keep mask launched
   once a batch; printed beside the card: the replay's ms a 16-frame step
   (median of 20, CUDA events), the program's FLOPs (FlopCounterMode) and
   MFU against the peak resolved from the card's name (never 197), the
   int8 weight residency against fp, the program footprint and graph pool
   bytes; gated: the HBM ledger's pools equal their own bytes, the budget
   is the card's total memory, ``/api/v1/hbm`` answers; ``int8_act``'s
   int8 convs (``down2``, ``c2f_2.cv1``) give the same int32 products on
   the card as their plain CPU version on the same quantized operands;
   (d) each variant's detections against the classic fp step's at mAP50
   (``s2d`` 0.95, ``int8`` 0.80, ``s2d_int8`` 0.80, ``int8_act`` 0.6, the
   tolerances of ``tools/bench_levers.py``), gated on that tool's own gate
   frames (4 of ``default_rng(7)``) at 270x480, the geometry its
   tolerances were measured on, through each engine's graphed program of
   that key; the scores on the 16 1080p frames are printed, not gated
   (there the JAX package's own gate falls below 0.95 for ``s2d``).
16. ROI serving at full width, hand-stepped engines (the JAX package's
   ROI tests' tick: collect, ``_roi_transform``, dispatch, drain) on the
   engine's compute stream: (a) ``tools/roi_smoke.py``'s scene at
   16x1080p on ``blob_gauge``: 8 streams with a blob of a key of its own
   moving 48 px a tick along x, 8 static scenes, each in a cell of a 4x4
   grid, 40 ticks paced to 30 a second, once with ``roi=False`` and once
   with ``roi=True`` (``roi_min_crop=80``, ``roi_full_interval_ms=500``,
   roi_smoke's); gated on roi_smoke's own gates: IoU with the analytic
   box >= 0.9 on average, no misrouted detection (off its stream's blob)
   and no unrouted canvas detection, the gate engaged (idle plus roi
   stream-ticks and a canvas served), stream results per device frame
   >= 2x the roi=False run's, the keep mask launched; (b) ``yolov8n`` bf16
   at 16x1080p, 12 ticks with roi off and on: phase 11's folds (roi and
   cascade off) must be 305268384 and 304869744; the canvas program's
   graph replay bit-identical to its eager step and one keep-mask launch
   in it (torch.profiler); printed: canvases and crops a tick, occupancy,
   the canvas replay's ms beside the full 16x1080p step's, the emit's ms a
   frame with roi on and off;
17. the temporal cascade at full width, hand-stepped: (a)
   ``tools/cascade_smoke.py``'s scene at 1080p on ``blob_gauge`` (a track
   whose blob flickers its blue channel +-15, two static tracks, three
   churn waves) with ``videomae_b``'s head every 4 ticks, gated on its
   five: the head at exactly 1/4 cadence, the enter event within 8 ticks
   of the onset, no event on a static track, the pool's high water at
   most the peak of concurrent tracks, one enter and one exit on the
   uplink and one archive segment; and the ``track_state`` pool of
   ``/api/v1/hbm`` equal to the pool's bytes; printed: the head's ms a
   dispatch, the pool's bytes, the harvest's ms a frame; (b)
   ``videomae_b_long``'s head (6272 tokens) on 2 tracks until its first
   pass: the flash forward among the head's kernels (torch.profiler) and
   launched, the head's logits within ``VIDEO_SWAP_TOL`` of the same head
   with the plain attention; (c) the harvest's host ms a frame with the
   cascade on, ``yolov8n`` at 16x1080p (about 100 tracked detections a
   frame), printed beside the emit's.
18. the other model families at full width, with seeded random weights:
   (a) ``yolov8s`` bf16 on 16x1080x1920 uint8 with ``quality_thumb=32``:
   shapes and finiteness, the same detections with the plain keep mask
   swapped in, the engine's graph replay bit-identical to the eager step
   on two inputs with one keep-mask launch a replay, float32 card vs CPU
   on two frames within phase 4's bars (TF32 off); ``resnet50``'s embed
   step on the same frames: [16, 2048] finite float32 embeddings, the
   replay bit-identical to eager, float32 card vs CPU within
   ``F32_EMBED_REL_TOL`` of the largest entry; ``mobilenet_v2`` at 1
   stream and at 16: the replay bit-identical to eager, float32 top-5 ids
   equal card vs CPU; printed: each replay's ms (CUDA events, median of
   20) and each model's peak memory (the stopped engines of earlier phases
   released first); (b) in a process of its own (``chip_smoke.py
   --fleet``: this process's allocator keeps the earlier phases' freed
   blocks reserved), the mixed fleet of BASELINE.md (6 ``yolov8n``, 5
   ``resnet50`` and 5 ``vit_b16`` streams) in one ``InferenceEngine`` with
   per-stream models on the memory bus, 1080p at 30 fps for 10 s as 11c
   publishes, every key prewarmed: gated on every
   stream served, each result's model its stream's, 2048-wide embeddings
   on the ``resnet50`` results, no logged tick or drain failure, and
   keep-mask launches equal to ``yolov8n``'s batches; printed: frames/s
   and p50/p95 latency per model.
19. the chaos soak of that fleet, in a process of its own
   (``chip_smoke.py --soak``): (a) ``lockstep_checksum`` twice over a
   recorded trace of 16 1080p streams, 8 frames each: the folds
   bit-identical; then ``run_fleet_soak`` of the 6 ``yolov8n`` + 5
   ``resnet50`` + 5 ``vit_b16`` ``fleetNN`` cameras at 1920x1080, bf16,
   on the memory bus, ``tick_ms=10``, looping a recorded 60-frame trace,
   20 s each: (b) the acceptance churn (``FaultPlan.default_churn``), (c)
   ``uplink_down``, ``bus_flap`` and ``device_stall``, (d)
   ``black_frame``, ``frozen_frame`` and ``score_drift``. Gated in each:
   0 misrouted results, every camera with results (and the canary in d),
   the uplink conserved and drained, subscriber drops within duration x
   streams x 30, the step cache stable, keep-mask launches equal to
   ``yolov8n``'s batches, no logged tick or drain failure; in (b) the
   killed camera suppressing while down; in (c) the breaker opened and
   closed; in (d) each quality fault detected within 5 s, no false
   positive, a canary episode, and detections on every ``yolov8n``
   stream outside the black one. Printed: per-family p50/p95/p99,
   results/s, bucket fill, each camera's published frames/s beside the 30
   offered, the ladder and the breaker;
20. the wire run, in a process of its own (``chip_smoke.py --e2e``):
   ``run_e2e`` of ``yolov8n`` at 1920x1080, a ``Server`` with one
   ``replay://`` worker at 30 fps on the shm bus and the gRPC
   ``Inference`` stream to a client thread, 20 s after a 15 s warmup:
   gated on results measured, keep-mask launches equal to the batches and
   no logged failure; printed: publish -> client-receive p50/p90/p95/p99
   beside the 40 ms limit, and the stage legs;
21. the camera tier, in a process of its own (``chip_smoke.py
   --camera``). First one line: whether ``g++ -E`` finds the FFmpeg
   development headers (``libavformat/avformat.h``,
   ``libavcodec/avcodec.h``, ``libswscale/swscale.h``) and whether ``cv2``
   imports. (a) The Redis wire, on the port's ``MiniRedis`` in a process
   of its own: 11a's trace (16x1080p, 8 frames each) through
   ``lockstep_checksum`` and the engine's ``serve_lockstep`` over a
   ``RedisFrameBus``, gated on 11a's and 11b's folds (305268384,
   304869744); then a ``Server`` with ``bus.backend: redis`` and 4 worker
   processes (``test://`` 1080p at 30 fps) for 15 s with its wire, gated
   on every camera answering a gRPC ``Inference`` client, annotations in
   the Redis queue, every worker exiting 0 at SIGTERM, no worker on the
   card and at least one keep-mask launch a batch; printed: frames/s and
   capture -> client-receive p50/p95/p99. Where the headers are found:
   (b) a 1920x1080 H.264 clip (90 frames, a keyframe every 30) encoded
   with the port's ``write_test_video``, decoded by 16 worker processes on
   the shm bus (a file endpoint each, re-opened at its end) and read by
   the default engine for 20 s: gated on ``vep_source_opens_total{kind=
   "packet"}`` counting 16 in the workers, every stream served,
   ``is_keyframe`` on every 30th packet, a keyframe-only camera decoding
   only its keyframes, every detection tracked, exit 0 at SIGTERM and no
   worker on the card; printed: frames/s and p50/p95/p99 beside 13b's, each
   worker's cores and CPU ms a decoded frame; (c) a worker process with
   ``disk_buffer_path`` archives the clip into MP4 segments that demux back
   with a keyframe head and the packets fed, and a worker relaying to an
   ``.flv`` file from the activating keyframe when ``proxy_rtmp`` turns on
   mid-GOP. Where the headers are absent, (b) and (c) do not run and the
   first line says so;
22. the fleet tier on the one card, in a process of its own
   (``chip_smoke.py --fleet-tier``), each member server a process of its
   own on the card (``--device cuda``, 2 torch threads) serving
   ``yolov8n`` at 1920x1080. First ``torch.cuda.mem_get_info()``. (a)
   Capacity: ``tools/torch_capacity_smoke.py``'s three parts, part A a
   hand-stepped engine with ROI, the cascade (``videomae_b``'s head every
   4 ticks) and the full path live on ``blob_gauge`` at 1080p, gated as
   ``CAPACITY_r01.json`` (conservation, the three kinds, headroom in
   [0, 1], the ledger tap under 1% of the tick budget, a monotone
   forecast, no admission on the saturating member, deterministic ties);
   (b) ``run_fleet_obs`` with 3 members, one 30 fps 1080p stream each,
   gated as ``FLEETOBS_r01.json``; (c) ``run_router_soak`` with 3
   serve-only members and 6 streams at 2 fps through the burn and the
   kill legs, gated as ``ROUTER_r01.json``; (d) ``run_autoscale_soak``
   with 2 members and one spawned from the prewarm manifest,
   ``mobilenet_v2`` tenants beside ``yolov8n``, gated as
   ``AUTOSCALE_r01.json``, the horizon scaled by the members' headroom
   after the base warmup against the artifact's spawn headroom. Each
   member printed: boot s, first frame s, device ms a batch at p50, peak
   reserved memory, torch threads and keep-mask launches against its
   ``yolov8n`` batches served after its ready line, gated ``launches ==
   batches > 0`` (``launches_fleet_tier``; 22a's in
   ``launches_capacity``). The legs run one after another, each stopping
   its members before the next starts.
23. the self-training loop on the card, in a process of its own
   (``chip_smoke.py --selftrain``): ``tools/torch_selftrain_e2e.py`` at
   ``SELFTRAIN_r05.json``'s recipe (``yolov8n`` at 640x640, 2 cameras x 6
   archived segments x 24 frames, batch 8, ``SELFTRAIN_STEPS`` steps (300,
   cut from its 600 for the script's time limit), lr 3e-3, 120 held-out images, ``clip_norm`` 10, BatchNorm statistics
   updated, bf16 compute over float32 weights): footage through the
   port's archiver and loader, an ultralytics-layout init through
   ``tools/torch_import_weights.py``, the fine-tune, pre and post mAP and
   the threshold's calibration through the serving program, the engine
   serving the init and the tuned checkpoint. First line: whether ``cv2``
   and ``msgpack`` import. Printed: the first and last loss, train ms a
   step at p50 and the train seconds, peak reserved memory, a step on a
   fixed batch (wall, CUDA events, the device's busy ms by torch.profiler
   and its idle share), the detection loss's and the assigner's ms a step
   (CUDA events), pre and post
   mAP/mAP50/mAP75 beside ``SELFTRAIN_r05.json``'s (a TPU record with
   other draws: not gated), the calibrated point, ``engine_pre`` and
   ``engine_post``, and keep-mask launches against each serving leg's
   batches. Gated on finite losses with the last below the first, post
   mAP50 > pre, every held-out image served by the engine before and
   after, the engine serving at the checkpoint's ``conf_threshold`` (its
   log line read), keep-mask launches == batches in each leg
   (``launches_selftrain``), and a checkpoint ``save_checkpoint`` wrote
   reloading into a fresh engine whose graphed step is bit-identical on
   one batch.

On the card the engine runs every serving step as a graph replay, so
phases 5, 8, 11, 13, 15-20 run graphed; phases 4, 6, 7, 9 and 10 call the eager
step, the model and the trainer directly.

After phase 8 the script reports what outlives its engines (the cuBLAS
workspace of each stream that ran a matmul, and the preprocessing
constants of every geometry met so far) and frees it, so that phase 9's
peak memory counts the training alone.

Phases 5, 8, 9, 11c, 13b, 14, 15c, 16a, 16b, 17a, 17b, 18b, 19b-d, 20,
21 (a, and b where it runs), 22 and 23 are the main paths: the kernels' launch counts are set to 0 just before each and read
just after it, and every kernel of that path must have launched (a graph
replay adds the launches its capture recorded); the keep mask's count in
13b is ``launches_frame_path``, in 14's first server (zeroed before its
engine starts) ``launches_server``, in 15c's served batches of each
variant ``launches_variants``, in 16a's ROI run ``launches_roi``, in 17a
``launches_cascade``, in 18b ``launches_fleet``, in 19b-d ``launches_soak``
(counted from each soak engine's ``start()``, after its prewarm), in 20
``launches_e2e``, in 22a ``launches_capacity``, in 22b-d
``launches_fleet_tier`` (each member's from its ready line), in 23's
serving legs ``launches_selftrain``, and the flash forward's in 17b
``launches_cascade``; the keep mask's line also carries
``replay_ms_yolov8s`` (18a). The line before the last is one JSON object describing
every kernel; the last line is ``{"ok": true, "device": {...}}``. Longer
output (the profile tables) goes to ``chiprun_out/``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s,
# float32 operations/s outside the tensor cores, and dense bf16
# operations/s of the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
# f32 operations per IoU pair of the keep mask: 4 min/max + 2 sub for the
# intersection sides, 2 clamps, 1 mul, 1 add + 1 sub for the union, 1 clamp,
# 1 div, 1 compare. Greedy NMS needs only the pairs j > i: K(K-1)/2 per image.
NMS_OPS_PER_PAIR = 14
# The keep mask's dependent chain: one step per candidate, each at least a
# bit test and an OR that waits for it, two dependent integer operations of
# about 4 cycles each on Hopper. A floor beside the roofline bound, which
# does not see the chain.
NMS_CHAIN_CYCLES_PER_STEP = 8
# The keep mask's edges in phase 3: one candidate, one and two 64-bit words
# per row, the largest K, at batches of 1, 16 and 40 (40 images launch more
# clusters than the card holds at once), and thresholds on both sides of 0.
NMS_EDGE_SHAPES = tuple((b, k) for b in (1, 16, 40) for k in (1, 64, 65, 1024))
NMS_EDGE_THRESHOLDS = (0.0, 0.45, 0.7, -0.1)

# Kinds of device work in a step's profile, by substrings of kernel names
# (the first kind that matches wins).
KERNEL_KINDS = (
    ("nms_keep_mask", ("nms_keep_mask",)),
    ("flash_attention_fwd", ("flash_fwd_kernel",)),
    ("flash_attention_bwd_dq", ("flash_bwd_dq_kernel",)),
    ("flash_attention_bwd_dkv", ("flash_bwd_dkv_kernel",)),
    ("optimizer", ("multi_tensor_apply",)),
    ("layernorm", ("layer_norm",)),
    ("softmax", ("softmax",)),
    ("gelu", ("gelu",)),
    ("convolution", ("fprop", "convolve", "cutlass")),
    ("batchnorm", ("bn_fw",)),
    ("dtype copy", ("copy_kernel",)),
    ("matmul", ("gemv", "gemm", "nvjet")),
    ("memcpy", ("Memcpy",)),
    ("cat", ("CatArray",)),
    ("silu", ("silu",)),
)

N_STREAMS = 16
FRAME_HW = (1080, 1920)
THUMB = 32
VIDEO_STREAMS = 2
VIT_FRAMES = 32

# Flash-attention tolerances. The kernel and its plain version both compute
# in float32 from the same inputs, in another order of summation: 1e-5 on
# O and LSE. A bf16 O is rounded once from the float32 result, so the two
# may also land one bf16 ulp apart, and one ulp of x is at most 2**-7 * |x|:
# 1e-5 + 2**-7 * |O| in bf16.
FLASH_TOL = 1e-5
FLASH_BF16_O_REL = 2.0 ** -7
# The videomae_b_long step with the plain attention swapped in: the two
# attention outputs differ by one bf16 ulp at some elements, and 12 bf16
# layers carry that on; 0.05 on float32 logits is far above it and far
# below a wrong attention.
VIDEO_SWAP_TOL = 0.05
# float32 on the card against float32 on the CPU (TF32 off): the same
# function through other matmul and convolution algorithms.
F32_LOGIT_TOL = 1e-3
# The backward kernels against their plain versions: both compute in
# float32 from the same inputs, dq summing over up to 6272 keys and dk/dv
# over 6272 queries. The float32 kernels agree with them bit for bit at the
# path's shapes on the H100 (their sequential FMAs follow cuBLAS's order);
# the bf16 tensor-core kernels sum in another order and carry p and ds as
# two bf16 halves, an error of order 2**-17 of each term. So the bar is the
# forward's: 1e-5, which leaves room for another order of summation of
# terms far below 1 (|dq|, |dk|, |dv| < 3 here), plus one bf16 ulp
# (2**-7 * |x|) of a bf16 gradient.
FLASH_BWD_TOL = 1e-5
# One bf16 videomae_b_long train step's gradients with the plain attention
# passes swapped in, as the relative L2 distance of all gradients: the two
# forward outputs differ by one bf16 ulp at some elements and 12 bf16
# layers carry that on; 0.05 is above that and far below a wrong
# gradient (a swapped or missing dq, dk or dv moves it by order 1).
TRAIN_SWAP_TOL = 0.05
# float32 gradients on the card against the CPU, each tensor's largest
# difference relative to its largest entry: other matmul and convolution
# orders through 2 layers give about 1e-6; 1e-4 is far above that noise.
F32_GRAD_REL_TOL = 1e-4
TRAIN_STEPS = 5


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi reported no GPU")
    return out[0].strip()


def max_sm_clock_mhz() -> float:
    """The card's maximum SM clock in MHz, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.split()
    return float(out[0])


def kernel_label(mangled: str) -> str:
    """A kernel instantiation's short name from its mangled name: the
    kernel, element type and head dim, as ``flash_bwd_dq_kernel<bf16,64>``."""
    import re

    base = re.search(r"([a-z_]+_kernel(?:_[a-z]+)?)", mangled)
    dim = re.search(r"Li(\d+)E", mangled)
    return (base.group(1) if base else mangled) + (
        f"<{'bf16' if 'bfloat16' in mangled else 'f32'},{dim.group(1)}>" if dim else "")


def ptxas_summary(text: str) -> list:
    """One entry per kernel instantiation in nvcc's ``-Xptxas=-v`` output:
    its name, element type and head dim (from the mangled name), its
    registers and its spill stores/loads in bytes."""
    import re

    out, label, spill = [], None, ""
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            label = kernel_label(m.group(1))
            spill = ""
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = f"{m.group(1)}/{m.group(2)} B spilled"
        m = re.search(r"Used (\d+) registers", ln)
        if m and label:
            smem = re.search(r"(\d+) bytes smem", ln)
            out.append(f"{label} {m.group(1)} registers, {spill}"
                       + (f", {smem.group(1)} B static smem" if smem else ""))
            label = None
    return out or [ln.strip() for ln in text.splitlines() if "registers" in ln or "spill" in ln]


def sass_hgmma_counts(library) -> dict:
    """{kernel function: number of HGMMA (wgmma) instructions} in the SASS
    of a built library, from the CUDA toolkit's ``cuobjdump``."""
    from video_edge_ai_proxy_tpu_torch.kernels import build

    sass = subprocess.run([build.toolkit_binary("cuobjdump"), "--dump-sass", str(library)],
                          check=True, capture_output=True, text=True, timeout=120).stdout
    counts, fn = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            fn = kernel_label(ln.split("Function :", 1)[1].strip())
            counts[fn] = 0
        elif fn is not None and "HGMMA" in ln:
            counts[fn] += 1
    return counts


def launched_kernels(fn, attempts: int = 3) -> list:
    """Names of the device kernels one call of ``fn`` launched, from
    torch.profiler. A session in which the profiler recorded no device
    event at all is profiled again, up to ``attempts`` times: on the H100
    it now and then records none for a session of one short kernel, which
    says nothing about the route."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = sorted({e.name for e in device_events(prof)})
        if names:
            return names
        log(f"profiler session {attempt + 1} of {attempts} recorded no device event "
            f"({len(prof.events())} events in all)")
    return []


def time_events(fn, iters: int) -> float:
    """Mean ms per call of ``fn`` between two CUDA events (after a warmup
    call): the device's time when the host keeps ahead, the host's launch
    rate when it does not."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profiled_device_ms(fn, iters: int, name_part: str):
    """Mean device ms per launch of the kernels whose name contains
    ``name_part`` over ``iters`` calls of ``fn`` (one launch each), from
    torch.profiler, averaged over the launches it recorded: it can miss
    some launches of a run of long kernels. None when it recorded none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = [e.device_time_total for e in device_events(prof) if name_part in e.name]
    return sum(times) / len(times) / 1000.0 if times else None


def device_events(prof):
    """The kernels (and device copies) a torch.profiler run recorded, not
    the device-side ranges of annotations (such as the optimizer's step),
    which would count their kernels twice."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def nms_boxes(gen, b: int, k: int, device, nonfinite: bool = False):
    """Random score-sorted candidate boxes with the edge cases of the main
    path: duplicates, zero-area boxes, all-zero (filtered) slots and
    class-offset boxes; with ``nonfinite``, also a few NaN, +inf and -inf
    coordinates."""
    import torch

    from video_edge_ai_proxy_tpu_torch.ops.nms import _CLASS_OFFSET

    xy = torch.rand((b, k, 2), generator=gen) * 600
    wh = torch.rand((b, k, 2), generator=gen) * 200 + 1
    boxes = torch.cat([xy, xy + wh], dim=-1)
    boxes[:, 1::7] = boxes[:, 0:1]                           # duplicates
    boxes[:, 3::11, 2] = boxes[:, 3::11, 0]                  # zero width
    boxes[:, -k // 8:] = 0.0                                 # filtered slots
    cls = torch.randint(0, 80, (b, k, 1), generator=gen).float()
    boxes = boxes + cls * _CLASS_OFFSET
    boxes[:, -k // 8:] = 0.0
    if nonfinite:
        boxes[:, 2::13, 0] = float("nan")
        boxes[:, 5::17, 3] = float("inf")
        boxes[:, 6::19, 1] = float("-inf")
        boxes[:, 9::23, 2] = float("inf")
    return boxes.to(device)


def nms_chain_boxes(b: int, k: int, device):
    """Unit squares 0.2 apart along x, the same in every image: each
    overlaps its neighbour with IoU 2/3 and the next but one with IoU 3/7,
    so at t = 0.45 greedy keeps every other box, and every odd row (rows 31
    and 63 of each 64-row block among them) is removed while its word still
    reaches the next row."""
    import torch

    x = torch.arange(k, dtype=torch.float32) * 0.2
    one = torch.stack([x, torch.zeros_like(x), x + 1.0, torch.ones_like(x)], dim=-1)
    return one.expand(b, k, 4).contiguous().to(device)


def profile_step(step, n_prof: int, card: str, title: str, out_name: str, tag: str):
    """Profile ``n_prof`` calls of ``step`` with torch.profiler: write every
    kernel (and device copy) grouped by name to ``chiprun_out/<out_name>``,
    log the busiest kernels and the device time by kind. Returns the
    device ms per step."""
    from torch.profiler import ProfilerActivity, profile

    import torch

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            step()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in device_events(prof):
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.device_time_total, n + 1)
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    dev_ms = sum(us for us, _ in by_name.values()) / n_prof / 1000.0
    launches_per_step = sum(n for _, n in by_name.values()) / n_prof
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", out_name), "w") as fh:
        fh.write(f"{card}\n{title}, {n_prof} steps profiled; {dev_ms:.3f} ms device, "
                 f"{launches_per_step:.0f} device launches per step\n"
                 f"ms/step  launches/step  kernel\n")
        for name, (us, n) in rows:
            fh.write(f"{us / n_prof / 1000.0:8.4f}  {n / n_prof:6.1f}  {name[:200]}\n")
        fh.write("\n" + prof.key_averages().table(sort_by="device_time_total", row_limit=40))
    log(f"{tag} profile: device busy {dev_ms:.3f} ms per step over "
        f"{launches_per_step:.0f} device launches; per-kernel table in chiprun_out/{out_name}")
    for name, (us, n) in rows[:5]:
        log(f"{tag} profile kernel: {us / n_prof / 1000.0:.4f} ms/step x{n / n_prof:.0f} "
            f"{name[:90]}")
    kinds: dict = {}
    for name, (us, n) in rows:
        kind = next((k for k, parts in KERNEL_KINDS if any(p in name for p in parts)), "other")
        k_us, k_n = kinds.get(kind, (0.0, 0))
        kinds[kind] = (k_us + us, k_n + n)
    log(f"{tag} profile by kind (ms/step, launches/step): " + ", ".join(
        f"{k} {us / n_prof / 1000.0:.4f} ({n / n_prof:.0f})"
        for k, (us, n) in sorted(kinds.items(), key=lambda kv: -kv[1][0])))
    return dev_ms


def set_attention(model, attn_fn) -> None:
    """Point every self-attention layer of ``model`` at ``attn_fn`` (None:
    the default, ``auto_attention``)."""
    from video_edge_ai_proxy_tpu_torch.models.transformer import SelfAttention

    for m in model.modules():
        if isinstance(m, SelfAttention):
            m.attn_fn = attn_fn


def plain_attention(q, k, v):
    """[B, T, H, D] attention through ``FlashAttention`` with the plain
    packed forward and backward in place of the kernels."""
    from video_edge_ai_proxy_tpu_torch.ops.flash_attention import PLAIN, FlashAttention

    return FlashAttention.apply(q, k, v, 128, 128, PLAIN)


def flash_bound_ms(bh: int, tp: int, d: int, true_t: int, elem_bytes: int):
    """(bytes bound, operations bound) in ms of one flash forward: q, k, v
    read once and o, lse written once; 4*BH*T*T*D operations (two products
    over the true_t real keys and queries) at the bf16 tensor-core rate."""
    nbytes = 4 * bh * tp * d * elem_bytes + bh * tp * 4
    ops = 4 * bh * true_t * true_t * d
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3


def check_flash(q, k, v, true_t: int) -> float:
    """The flash kernel against its plain version on q, k, v: raises above
    the tolerances; returns (worst, O difference, LSE difference)."""
    import torch

    from video_edge_ai_proxy_tpu_torch.kernels.flash import flash_attention_fwd_cuda
    from video_edge_ai_proxy_tpu_torch.ops.flash_attention import flash_attention_reference

    o, lse = flash_attention_fwd_cuda(q, k, v, true_t)
    torch.cuda.synchronize()
    want_o, want_lse = flash_attention_reference(q, k, v, true_t)
    o, want_o = o.float(), want_o.float()
    diff = (o - want_o).abs()
    o_tol = FLASH_TOL
    if q.dtype == torch.bfloat16:
        o_tol = o_tol + FLASH_BF16_O_REL * torch.maximum(o.abs(), want_o.abs())
    o_ok = bool((diff <= o_tol).all())
    o_err, lse_err = float(diff.max()), float((lse - want_lse).abs().max())
    if not (bool(torch.isfinite(o).all()) and o_ok and lse_err <= FLASH_TOL):
        raise AssertionError(f"flash kernel differs from its plain version at "
                             f"{tuple(q.shape)} {q.dtype} true_t={true_t}: O {o_err:.3g} "
                             f"(tolerance 1e-5, plus one ulp in bf16), LSE {lse_err:.3g} "
                             f"(tolerance {FLASH_TOL})")
    return max(o_err, lse_err), o_err, lse_err


def flash_bwd_bound_ms(bh: int, tp: int, d: int, true_t: int, elem_bytes: int, dkv: bool):
    """(bytes bound, operations bound) in ms of one backward kernel: q, k,
    v, dO, lse and delta read once and dq (or dk and dv) written once;
    6*BH*T*T*D operations for dq (three products over the true_t real keys
    and queries), 8*BH*T*T*D for dk/dv (four), at the bf16 tensor-core rate."""
    nbytes = (4 + (2 if dkv else 1)) * bh * tp * d * elem_bytes + 2 * bh * tp * 4
    ops = (8 if dkv else 6) * bh * true_t * true_t * d
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3


def bwd_inputs(q, k, v, true_t: int, gen):
    """dO (random, zero on the padded query rows as autograd gives it),
    the plain forward's lse and delta = rowsum(dO * O) for packed q, k, v."""
    import torch

    from video_edge_ai_proxy_tpu_torch.ops.flash_attention import flash_attention_reference

    do = torch.randn(q.shape, generator=gen, device=q.device).to(q.dtype)
    do[:, true_t:] = 0
    o, lse = flash_attention_reference(q, k, v, true_t)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    return do, lse, delta


def check_flash_bwd(q, k, v, do, lse, delta, true_t: int):
    """The two backward kernels against their plain versions: raises above
    the tolerances; returns {"dq": err, "dkv": err}."""
    import torch

    from video_edge_ai_proxy_tpu_torch.kernels.flash import (
        flash_attention_bwd_dkv_cuda, flash_attention_bwd_dq_cuda,
    )
    from video_edge_ai_proxy_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_dkv_reference, flash_attention_bwd_dq_reference,
    )

    args = (q, k, v, do, lse, delta, true_t)
    got = {"dq": (flash_attention_bwd_dq_cuda(*args),),
           "dkv": flash_attention_bwd_dkv_cuda(*args)}
    torch.cuda.synchronize()
    want = {"dq": (flash_attention_bwd_dq_reference(*args),),
            "dkv": flash_attention_bwd_dkv_reference(*args)}
    errs = {}
    for name in got:
        errs[name] = 0.0
        for g, w in zip(got[name], want[name]):
            g, w = g.float(), w.float()
            diff = (g - w).abs()
            tol = FLASH_BWD_TOL
            if q.dtype == torch.bfloat16:
                tol = tol + FLASH_BF16_O_REL * torch.maximum(g.abs(), w.abs())
            if not (bool(torch.isfinite(g).all()) and bool((diff <= tol).all())):
                raise AssertionError(f"flash backward kernel {name} differs from its plain "
                                     f"version at {tuple(q.shape)} {q.dtype} true_t={true_t}: "
                                     f"{float(diff.max()):.3g} (tolerance {FLASH_BWD_TOL}, "
                                     f"plus one ulp in bf16)")
            errs[name] = max(errs[name], float(diff.max()))
        if name == "dkv" and any(bool(g[:, true_t:].any()) for g in got[name]):
            raise AssertionError("dk/dv kernel left nonzero gradients on padded keys")
    return errs


def step_grads(model, x, labels):
    """(loss, {name: gradient}) of one cross-entropy forward and backward of
    ``model`` in train mode; the parameters do not move."""
    from video_edge_ai_proxy_tpu_torch.parallel import cross_entropy_loss

    model.train()
    model.zero_grad(set_to_none=True)
    loss = cross_entropy_loss(model, x, labels)
    loss.backward()
    grads = {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def grad_distance(got: dict, want: dict):
    """(relative L2 distance of all gradients, the worst tensor's largest
    difference relative to its largest entry, that tensor's name)."""
    num = sum(float(((got[n] - want[n]) ** 2).sum()) for n in want)
    den = sum(float((want[n] ** 2).sum()) for n in want)
    worst, worst_name = 0.0, ""
    for n in want:
        rel = float((got[n] - want[n]).abs().max()) / max(float(want[n].abs().max()), 1e-30)
        if rel > worst:
            worst, worst_name = rel, n
    return (num / max(den, 1e-30)) ** 0.5, worst, worst_name


class ReadTrackingBus:
    """Wraps a frame bus and records the newest seq read per stream, so a
    feeder can publish one frame per stream per collector tick."""

    def __init__(self, bus):
        self._bus = bus
        self.read: dict = {}

    def read_latest(self, device_id, min_seq=0):
        frame = self._bus.read_latest(device_id, min_seq)
        if frame is not None:
            self.read[device_id] = frame.seq
        return frame

    def __getattr__(self, name):
        return getattr(self._bus, name)


# -- phase 11: the serving pipeline ---------------------------------------------------

# The paced runs: 16 streams published in phase at 30 fps, each cycling
# through PACED_POOL distinct pattern frames, on the repo's detection
# traffic (the class prior zeroed, as bench.py and phases 4 and 11a-b).
# 11c: the default EngineConfig for PACED_S, then up to SETTLE_S for the
# ladder to come back to normal with no new frames. Its SLOs reach no
# verdict: slo_warmup_s is 60 s.
PACED_FPS = 30.0
PACED_S = 20.0
SETTLE_S = 10.0
PACED_POOL = 30
# 11d: the same traffic with slo_warmup_s cut, so that the SLO plane
# reaches its verdict within SLO_RUN_S, and every bucket's program
# prewarmed; the first PROFILE_S under torch.profiler.
SLO_WARMUP_S = 3.0
SLO_RUN_S = 12.0
PROFILE_S = 3.0
# Replay: 8 frames of each of the 16 streams.
REPLAY_FRAMES = 8
# CUDA runtime calls that block the calling thread until the device work
# queued before them has finished.
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")
# CUDA runtime calls that put work on a stream: kernel launches (the
# cluster launch of the keep mask is cudaLaunchKernelExC), graph launches
# and asynchronous copies and fills.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch",
                "cudaMemcpyAsync", "cudaMemsetAsync")
# 11b's fold with the eager step on an NVIDIA H100 80GB HBM3: a graph
# replays the eager step's kernels on the same inputs, so the graphed
# engine should fold the same integer.
EAGER_ENGINE_FOLD = 304869744


def pct(values, p):
    """The p-th percentile of ``values`` (linear interpolation)."""
    s = sorted(values)
    if not s:
        return float("nan")
    k = (len(s) - 1) * p / 100.0
    lo = int(math.floor(k))
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (k - lo)


def paced_publish(bus, streams, pool, seconds: float, on_round=None):
    """Publish one frame per stream every 1/PACED_FPS s for ``seconds``,
    stream i at frame (n + 2i) of ``pool`` in round n; a frame's capture
    stamp is its publish, as a camera worker stamps the frame it
    publishes. ``on_round(t)`` runs after each round, t the seconds since
    the start. Returns (frames published, wall s, ms late per late round)."""
    from video_edge_ai_proxy_tpu_torch.bus.interface import FrameMeta

    h, w = pool[0].shape[:2]
    late_ms = []
    t_start = time.monotonic()
    n = 0
    while n / PACED_FPS < seconds:
        wait = t_start + n / PACED_FPS - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        else:
            late_ms.append(-wait * 1000.0)
        for i, s in enumerate(streams):
            bus.publish(s, pool[(n + 2 * i) % len(pool)],
                        FrameMeta(width=w, height=h, packet=n,
                                  timestamp_ms=int(time.time() * 1000)))
        n += 1
        if on_round is not None:
            on_round(time.monotonic() - t_start)
    return n * len(streams), time.monotonic() - t_start, late_ms


def sync_sites(fn) -> dict:
    """{source line: count} of the operations of one call of ``fn`` that
    synchronise the host with the card (copies between pageable host
    memory and the card, ``item()``, ``nonzero()``), from
    ``torch.cuda.set_sync_debug_mode``'s warnings, each at the Python line
    that made it."""
    import warnings

    import torch

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    out: dict = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            site = f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
            out[site] = out.get(site, 0) + 1
    return out


def pipeline_phase(dev, card: str, zero_launches, read_launches, kernels) -> dict:
    """Phase 11: the default engine's pipeline on yolov8n bf16 at 16x1080p:
    (a) replay twice, (b) pipelined against synchronous, (c) a paced run,
    (d) the paced run's host syncs and its SLO verdict. Returns 11a's and
    11b's folds and 11c's frames/s and latency percentiles, which phase 13
    prints beside its own."""
    import tempfile

    import numpy as np
    import torch

    from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
    from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine
    from video_edge_ai_proxy_tpu_torch.ingest.sources import SyntheticSource
    from video_edge_ai_proxy_tpu_torch.models import registry
    from video_edge_ai_proxy_tpu_torch.replay.checksum import check_golden, zero_class_prior
    from video_edge_ai_proxy_tpu_torch.replay.harness import lockstep_checksum
    from video_edge_ai_proxy_tpu_torch.replay.player import TracePlayer
    from video_edge_ai_proxy_tpu_torch.replay.recorder import record_synthetic_trace
    from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig

    spec = registry.get("yolov8n")
    streams = [f"cam{i:02d}" for i in range(N_STREAMS)]
    model = spec.init_params(torch.Generator().manual_seed(0), device=dev)
    model.load_state_dict(zero_class_prior(model.state_dict()))
    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}

    # (a) replay twice, and once with one weight moved.
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = record_synthetic_trace(os.path.join(tmp, "pipeline.vtrace"), streams,
                                      width=FRAME_HW[1], height=FRAME_HW[0], fps=30.0,
                                      frames=REPLAY_FRAMES)
        runs = [lockstep_checksum(path, model="yolov8n", device=dev, state_dict=weights)
                for _ in range(2)]

        def perturb(sd):
            # One element of the stem conv, the first layer, as the JAX
            # package's replay test perturbs the first weight of its tree.
            sd = dict(sd)
            w = sd["stem.conv.weight"].clone()
            w[(0,) * w.ndim] += 0.25
            sd["stem.conv.weight"] = w
            return sd

        moved = lockstep_checksum(path, model="yolov8n", device=dev, state_dict=weights,
                                  perturb=perturb)
        by_packet: dict = {}
        for dev_id, frame, meta in TracePlayer(path).iter_frames():
            by_packet.setdefault(meta.packet, []).append((dev_id, frame, meta))
    if runs[0] != runs[1]:
        raise AssertionError(f"two replays of one trace differ: {runs}")
    if moved["checksum"] == runs[0]["checksum"]:
        raise AssertionError("a perturbed weight did not move the replay checksum")
    if runs[0]["frames"] != N_STREAMS * REPLAY_FRAMES or runs[0]["checksum"] == 0:
        raise AssertionError(f"replay served {runs[0]}")
    golden = check_golden("lockstep:yolov8n:cuda", runs[0]["checksum"], tool="chip_smoke")
    log(f"phase 11a replay: {runs[0]['frames']} frames of {N_STREAMS} streams at "
        f"{FRAME_HW[1]}x{FRAME_HW[0]} in {runs[0]['batches']} batches, checksum "
        f"{runs[0]['checksum']} twice (golden {golden if golden is not None else 'not committed'}); "
        f"a perturbed weight gives {moved['checksum']}; {time.perf_counter() - t0:.2f} s")

    # (b) the pipelined engine against the synchronous path, same frames.
    ticks = [by_packet[n] for n in sorted(by_packet)]
    folds = {}
    for prefetch in (True, False):
        engine = InferenceEngine(MemoryFrameBus(), EngineConfig(prefetch=prefetch), device=dev,
                                 model=model)
        folds[prefetch] = (engine.serve_lockstep(ticks), engine.pipeline_stats().frames)
        del engine
    piped, sync = folds[True], folds[False]
    if piped != sync or piped[1] != N_STREAMS * REPLAY_FRAMES or piped[0] == 0:
        raise AssertionError(f"pipelined (checksum, frames) {piped} != synchronous {sync}")
    log(f"phase 11b engine: prefetch and drain thread fold {piped[0]} over {piped[1]} "
        f"results, the synchronous path the same, bit for bit; the eager step's fold "
        f"{EAGER_ENGINE_FOLD}: {'the same' if piped[0] == EAGER_ENGINE_FOLD else 'differs'}")
    del ticks, by_packet

    # (c) a paced run: 16 streams at 30 fps on distinct frames.
    pool = [SyntheticSource.render(FRAME_HW[0], FRAME_HW[1], n) for n in range(PACED_POOL)]
    bus = MemoryFrameBus()
    for s in streams:
        bus.create_stream(s, FRAME_HW[0] * FRAME_HW[1] * 3)
    engine = InferenceEngine(bus, EngineConfig(), device=dev, model=model)
    results = engine.subscribe()
    got: dict = {}

    def consume():
        for r in results:
            got.setdefault(r.device_id, []).append(r)

    reader = threading.Thread(target=consume, daemon=True)
    reader.start()
    engine.warmup()
    zero_launches()
    engine.start()
    threads0 = thread_cpu_seconds(engine)
    probe = WakeProbe(PACED_S)
    try:
        published, wall_s, late_ms = paced_publish(bus, streams, pool, PACED_S)
        threads1 = thread_cpu_seconds(engine)
        wake = probe.result()
        slo_verdict = engine.slo.snapshot()
        settle = time.monotonic() + SETTLE_S
        while engine.ladder.rung != "normal" and time.monotonic() < settle:
            time.sleep(0.1)
        rung = engine.ladder.rung
        health = engine.health()
    finally:
        engine.stop()
    launches = read_launches()
    reader.join(10)
    if reader.is_alive():
        raise AssertionError("paced-run subscriber did not end")
    p = engine.pipeline_stats()
    graphs = engine.graph_stats()
    missing = [s for s in streams if not got.get(s)]
    lat = [r.latency_ms for v in got.values() for r in v]
    dets = [d for v in got.values() for r in v for d in r.detections]
    untracked = sum(1 for d in dets if not d.track_id)
    quality = engine.quality.snapshot()
    log(f"phase 11c paced run: {N_STREAMS} streams x {PACED_FPS:g} fps for {wall_s:.3f} s, "
        f"{published} frames published, {p.frames} results ({p.frames / wall_s:.2f} frames/s), "
        f"{p.batches} batches ({p.frames / max(p.batches, 1):.2f} frames per batch), "
        f"{p.shed_frames} shed ({p.shed_frames / max(published, 1):.4f} of published), "
        f"{published - p.frames - p.shed_frames} superseded or pending (latest-wins)")
    log(f"phase 11c capture->result latency ms: p50 {pct(lat, 50):.3f}, p95 {pct(lat, 95):.3f}, "
        f"p99 {pct(lat, 99):.3f}, max {max(lat) if lat else float('nan'):.3f} against the "
        f"{engine._cfg.slo_latency_ms:g} ms limit; mean by stage: capture->collect "
        f"{p.capture_to_collect_ms / max(p.frames, 1):.3f}, collect->submit "
        f"{p.collect_to_submit_ms / max(p.frames, 1):.3f}, submit->drained "
        f"{p.submit_to_drained_ms / max(p.frames, 1):.3f}, drained->emitted "
        f"{p.drained_to_emitted_ms / max(p.frames, 1):.3f}")
    log(f"phase 11c device: H2D {p.h2d_ms:.3f} ms in all ({p.h2d_ms / max(p.batches, 1):.3f} ms "
        f"per batch), {p.h2d_overlapped_ms:.3f} ms of it ({p.h2d_overlapped_ms / max(p.h2d_ms, 1e-9):.4f}) "
        f"overlapped with a batch in flight; step spans on the compute stream "
        f"{p.device_ms:.3f} ms = {p.device_ms / (wall_s * 1000.0):.4f} of the wall time "
        f"({p.device_ms / max(p.batches, 1):.3f} ms per batch); graphs "
        f"{graphs['programs']} captured in {graphs['capture_s']:.3f} s, pool "
        f"{graphs['pool_bytes'] / 2 ** 20:.1f} MiB; pinned batch pool "
        f"{engine._collector.pool_nbytes() / 2 ** 20:.1f} MiB; publisher late "
        f"{len(late_ms)} times (max {max(late_ms) if late_ms else 0.0:.3f} ms); cores used "
        f"by thread (main = the publisher): {thread_cores(threads0, threads1, wall_s)}; "
        f"a {WAKE_SLEEP_S * 1000:g} ms sleep wakes late by: {wake}")
    log(f"phase 11c drain and planes: {len(dets)} detections "
        f"({len(dets) / max(p.frames, 1):.2f} per result, class prior zeroed), {untracked} "
        f"without a track id; the drain's emit {p.emit_ms / max(p.frames, 1):.4f} ms a frame "
        f"(tracker {p.track_ms / max(p.frames, 1):.4f}); ladder {rung}, transitions "
        f"{engine.ladder.transitions}; quality unhealthy {quality['unhealthy']}; SLOs at "
        f"{wall_s:.1f} s (warmup {engine._cfg.slo_warmup_s:g} s): burning "
        f"{slo_verdict['burning']}, fast burn "
        f"{ {n: v['burn']['fast'] for n, v in slo_verdict['slos'].items()} }; health ok "
        f"{health['ok']}; kernel launches {launches}")
    out = {"11a": runs[0]["checksum"], "11b": piped[0], "fps": p.frames / wall_s,
           "p50": pct(lat, 50), "p95": pct(lat, 95), "p99": pct(lat, 99)}
    if missing:
        raise AssertionError(f"paced run: streams without results: {missing}")
    if not dets or untracked:
        raise AssertionError(f"paced run: {untracked} of {len(dets)} detections without a "
                             f"track id")
    if rung != "normal":
        raise AssertionError(f"paced run: the ladder ended at {rung!r}")
    if not health["ok"]:
        raise AssertionError(f"paced run: engine unhealthy {health}")
    for name, meta in kernels.items():
        if meta["path"] == "detect" and launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched in the paced run")
    del engine

    pipeline_slo_phase(dev, card, model, spec, streams, pool)
    del model, pool
    torch.cuda.empty_cache()
    return out


def pipeline_slo_phase(dev, card: str, model, spec, streams, pool) -> None:
    """Phase 11d: the step's synchronising operations, then 11c's traffic
    with the SLO warmup cut to SLO_WARMUP_S: its first PROFILE_S under
    torch.profiler, then the SLO verdict and the rung it drives the
    ladder to."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
    from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine, build_serving_step
    from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig

    # The step alone: where its synchronising operations are.
    step = build_serving_step(model, spec, quality_thumb=32)
    x = torch.from_numpy(np.stack(pool[:N_STREAMS])).to(dev)
    thumbs = torch.zeros((N_STREAMS, 32, 32), dtype=torch.float32, device=dev)
    step(x, thumbs)
    torch.cuda.synchronize()
    sites = sync_sites(lambda: step(x, thumbs))
    log(f"phase 11d the step alone: {sum(sites.values())} synchronising operations a call"
        + "".join(f", {site} x{n}" for site, n in sorted(sites.items())))
    if sites:
        raise AssertionError(f"phase 11d: the eager step synchronises with the host: {sites}")
    del x, thumbs, step

    bus = MemoryFrameBus()
    for s in streams:
        bus.create_stream(s, FRAME_HW[0] * FRAME_HW[1] * 3)
    # The programs of every bucket are captured at start(), so that the
    # profile sees the steady state and no capture's eager warmup calls.
    engine = InferenceEngine(bus, EngineConfig(
        slo_warmup_s=SLO_WARMUP_S,
        prewarm=[[FRAME_HW[0], FRAME_HW[1], b] for b in (1, 2, 4, 8, N_STREAMS)]),
        device=dev, model=model)
    results = engine.subscribe()
    arrivals = []

    def consume():
        for r in results:
            arrivals.append((time.monotonic(), r.device_id))

    reader = threading.Thread(target=consume, daemon=True)
    reader.start()
    engine.warmup()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    marks: dict = {}

    def on_round(t):
        if "profiled_batches" not in marks and t >= PROFILE_S:
            prof.stop()
            marks["profiled_batches"] = engine.pipeline_stats().batches
        if "burning" not in marks and engine.slo.burning():
            marks["burning"] = t
        if "paused" not in marks and engine.ladder.rung == "admission_pause":
            marks["paused"] = t

    engine.start()      # the prewarm's captures and their eager warmup calls come first
    prof.start()
    try:
        published, wall_s, late_ms = paced_publish(bus, streams, pool, SLO_RUN_S, on_round)
        t_end = time.monotonic()
        verdict = engine.slo.snapshot()
        rung = engine.ladder.rung
    finally:
        engine.stop()
    reader.join(10)
    if reader.is_alive():
        raise AssertionError("phase 11d subscriber did not end")
    p = engine.pipeline_stats()
    batches = max(marks.get("profiled_batches", 0), 1)
    calls: dict = {}
    for e in prof.events():
        if e.name.startswith(("cuda", "Memcpy")):
            kind = "device" if e.device_type == DeviceType.CUDA else "host"
            calls[kind, e.name] = calls.get((kind, e.name), 0) + 1
    log(f"phase 11d profile of the first {PROFILE_S:g} s of the paced run on {card}: "
        f"{batches} batches; per batch: launches "
        + ", ".join(f"{c} {calls.get(('host', c), 0) / batches:.2f}" for c in LAUNCH_CALLS)
        + "; blocking runtime calls "
        + ", ".join(f"{c} {calls.get(('host', c), 0) / batches:.2f}" for c in SYNC_CALLS)
        + "; device copies " + (", ".join(f"{c} {n / batches:.2f}" for (k, c), n in
                                         sorted(calls.items()) if k == "device")
                                or "none recorded"))
    recent = {d for t, d in arrivals if t >= t_end - 2.0}
    log(f"phase 11d SLO plane (slo_warmup_s {SLO_WARMUP_S:g} s and the buckets prewarmed, the "
        f"default EngineConfig otherwise; {published} frames published in {wall_s:.3f} s, {p.frames} results, "
        f"publisher late {len(late_ms)} times): burning from t = "
        f"{marks.get('burning', float('nan')):.2f} s; per SLO (fast burn, firing): "
        + ", ".join(f"{n} ({v['burn']['fast']}, {v['firing']})"
                    for n, v in verdict["slos"].items())
        + f"; ladder at admission_pause from t = {marks.get('paused', float('nan')):.2f} s, "
        f"{rung} at the end, transitions {engine.ladder.transitions}; {len(recent)} of "
        f"{N_STREAMS} streams served in the last 2 s")
    if not verdict["slos"]["aggregate_fps"]["firing"] or rung != "admission_pause":
        raise AssertionError("phase 11d: the fps objective (target above the offered "
                             "480 frames/s) did not fire, or the ladder did not end at "
                             "admission_pause")
    if not recent:
        raise AssertionError("phase 11d: no stream served under admission_pause")


# -- phase 12: the compiled step ----------------------------------------------------------


def median_call_ms(fn, iters: int = 20):
    """Medians over ``iters`` calls of ``fn`` (after one warm call), each
    ending in a synchronise: (wall ms, ms between CUDA events recorded on
    the current stream around the call)."""
    import torch

    fn()
    walls, evs = [], []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1000.0)
        evs.append(start.elapsed_time(end))
    return statistics.median(walls), statistics.median(evs)


def one_call_profile(fn, attempts: int = 3):
    """torch.profiler of one call of ``fn``: ({host runtime call: count}
    for LAUNCH_CALLS and SYNC_CALLS, [device kernel names]). A session
    with no device event is profiled again, as ``launched_kernels`` does."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e.name for e in device_events(prof)]
        if kernels:
            break
        log(f"profiler session {attempt + 1} of {attempts} recorded no device event")
    host: dict = {}
    for e in prof.events():
        if e.name in LAUNCH_CALLS + SYNC_CALLS and e.device_type == DeviceType.CPU:
            host[e.name] = host.get(e.name, 0) + 1
    return host, kernels


def graphed_against_eager(tag: str, card: str, engine, eager, inputs: list, src_hw: tuple,
                          must_run: str):
    """Phase 12 (a)/(b): the engine's graphed step of ``inputs[0]``'s key
    against ``eager`` on three distinct inputs, bit for bit; syncs, memory,
    timing, host calls and the replay's kernels (``must_run`` among them).
    Returns the graphed step."""
    import torch

    dev = inputs[0][0].device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.inference_mode():
        want = [eager(*x) for x in inputs]
        torch.cuda.synchronize()
    eager_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    torch.cuda.reset_peak_memory_stats(dev)
    with engine._compute_stream(), torch.inference_mode():
        step = engine._step(src_hw, inputs[0][0].shape[0])
        step(*inputs[-1])                     # the first call: warmup, capture, replay
        torch.cuda.synchronize()
        capture_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
        torch.cuda.reset_peak_memory_stats(dev)
        got = [step(*x) for x in inputs]      # all three held until the last has run
        torch.cuda.synchronize()
    graph_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    for i, (g, w) in enumerate(zip(got, want)):
        for k in w:
            if g[k].dtype != w[k].dtype or not torch.equal(g[k], w[k]):
                bad = (g[k].float() - w[k].float()).abs().max() if g[k].shape == w[k].shape \
                    else g[k].shape
                raise AssertionError(f"phase 12{tag}: input {i}: the graphed {k} differs from "
                                     f"eager ({bad})")
    if all(torch.equal(got[0][k], got[1][k]) for k in got[0]):
        raise AssertionError(f"phase 12{tag}: two distinct inputs gave the same outputs")
    stats = engine.graph_stats()
    log(f"phase 12{tag} graphed step: {len(inputs)} distinct inputs replayed back to back, "
        f"every output ({', '.join(sorted(got[0]))}) bit-identical to the eager step; capture "
        f"{step.capture_s:.4f} s, graph pool {stats['pool_bytes'] / 2 ** 20:.1f} MiB, static "
        f"input {step.frames_in.numel() / 2 ** 20:.1f} MiB; peak memory {graph_peak:.1f} MiB "
        f"(3 replays held; {capture_peak:.1f} MiB over the first call's warmup and capture) "
        f"against the eager step's {eager_peak:.1f} MiB (3 calls held)")
    del got, want

    x = inputs[0]
    with torch.inference_mode():
        eager_sites = sync_sites(lambda: eager(*x))
        with engine._compute_stream():
            graph_sites = sync_sites(lambda: step(*x))
            g_wall, g_ev = median_call_ms(lambda: step(*x))
            g_host, g_kernels = one_call_profile(lambda: step(*x))
        e_wall, e_ev = median_call_ms(lambda: eager(*x))
        e_host, e_kernels = one_call_profile(lambda: eager(*x))
    log(f"phase 12{tag} synchronising operations a call: replay {sum(graph_sites.values())}, "
        f"eager {sum(eager_sites.values())}" + "".join(
            f", {site} x{n}" for site, n in sorted({**graph_sites, **eager_sites}.items())))
    if graph_sites or eager_sites:
        raise AssertionError(f"phase 12{tag}: synchronising operations {graph_sites} "
                             f"{eager_sites}")
    log(f"phase 12{tag} timing on {card}: replay median {g_wall:.3f} ms wall, {g_ev:.3f} ms "
        f"CUDA events (copy-in, replay, copy-out); eager median {e_wall:.3f} ms wall, "
        f"{e_ev:.3f} ms CUDA events; median of 20 each")
    log(f"phase 12{tag} one call by torch.profiler: replay {len(g_kernels)} device kernels and "
        f"copies, host calls {g_host}; eager {len(e_kernels)} device kernels and copies, host "
        f"calls {e_host}")
    if not any(must_run in name for name in g_kernels):
        raise AssertionError(f"phase 12{tag}: no {must_run} among the replay's device "
                             f"kernels: {sorted(set(g_kernels))[:20]}")
    return step


def graphs_phase(dev, card: str, report: dict) -> None:
    """Phase 12: the engine's compiled step, (a) detection and (b) long
    clips graphed against eager, (c) prewarm from ``cfg.prewarm`` and from
    the prewarm manifest."""
    import tempfile

    import torch

    from video_edge_ai_proxy_tpu_torch.bus.interface import FrameMeta
    from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
    from video_edge_ai_proxy_tpu_torch.engine import aot_cache
    from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine, build_serving_step
    from video_edge_ai_proxy_tpu_torch.models import registry
    from video_edge_ai_proxy_tpu_torch.obs import metrics
    from video_edge_ai_proxy_tpu_torch.replay.checksum import zero_class_prior
    from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig

    gen = torch.Generator(device=dev).manual_seed(12)

    # (a) the detection step.
    spec = registry.get("yolov8n")
    model = spec.init_params(torch.Generator().manual_seed(0), device=dev)
    model.load_state_dict(zero_class_prior(model.state_dict()))
    inputs = [(torch.randint(0, 256, (N_STREAMS,) + FRAME_HW + (3,), generator=gen,
                             dtype=torch.uint8, device=dev),
               torch.rand((N_STREAMS, THUMB, THUMB), generator=gen, device=dev))
              for _ in range(3)]
    engine = InferenceEngine(MemoryFrameBus(), EngineConfig(), device=dev, model=model)
    engine.warmup()
    step = graphed_against_eager("a", card, engine, build_serving_step(model, spec,
                                                                       quality_thumb=THUMB),
                                 inputs, FRAME_HW, "nms_keep_mask")
    with engine._compute_stream(), torch.inference_mode():
        replay_ms = profiled_device_ms(lambda: step(*inputs[0]), 10, "nms_keep_mask")
    report["nms_keep_mask"]["replay_ms"] = replay_ms
    log(f"phase 12a nms_keep_mask inside a replay on {card}: {replay_ms} ms a launch "
        f"(profiler, 10 replays)")
    del engine, step, inputs

    # (c) prewarm from cfg.prewarm, then from the manifest alone.
    streams = [f"cam{i:02d}" for i in range(N_STREAMS)]
    frame = torch.randint(0, 256, FRAME_HW + (3,), generator=torch.Generator().manual_seed(13),
                          dtype=torch.uint8).numpy()
    misses = metrics.registry.counter("vep_step_cache_misses_total").labels()
    hits = metrics.registry.counter("vep_step_cache_hits_total").labels()
    with tempfile.TemporaryDirectory() as tmp:
        for prewarm in ([[FRAME_HW[0], FRAME_HW[1], N_STREAMS]], []):
            bus = MemoryFrameBus()
            for s in streams:
                bus.create_stream(s, frame.nbytes)
                bus.publish(s, frame, FrameMeta(width=FRAME_HW[1], height=FRAME_HW[0],
                                                packet=1))
            eng = InferenceEngine(bus, EngineConfig(prewarm=prewarm, aot_cache=True,
                                                    aot_cache_dir=tmp), device=dev,
                                  model=model)
            before = eng.prewarm_status()
            m0, h0 = misses.value, hits.value
            # A subscriber over every stream: the engine infers only what
            # someone reads (interest gating).
            eng.subscribe(streams)
            t0 = time.perf_counter()
            eng.start()
            start_s = time.perf_counter() - t0
            try:
                status = eng.prewarm_status()
                deadline = time.monotonic() + 60
                while any(eng.stats().get(s) is None for s in streams):
                    if time.monotonic() > deadline:
                        raise AssertionError("phase 12c: the prewarmed engine did not serve")
                    time.sleep(0.005)
            finally:
                eng.stop()
            d_miss, d_hit = misses.value - m0, hits.value - h0
            batches = eng.pipeline_stats().batches
            log(f"phase 12c prewarm {'from cfg.prewarm' if prewarm else 'from the manifest'}: "
                f"status {before} before start(), {status} after it ({start_s:.3f} s); "
                f"{eng.graph_stats()['programs']} graph captured; step-cache misses "
                f"+{d_miss:g} (the prewarm), hits +{d_hit:g} over {batches} batches served; "
                f"manifest {aot_cache.load_manifest(tmp)}")
            # The one miss is the prewarm's capture: every batch served hit.
            if status != {"required": 1, "done": 1, "complete": True, "aot_cache": True} \
                    or before["complete"] or d_miss != 1 or batches < 1 or d_hit != batches \
                    or eng.graph_stats()["programs"] != 1:
                raise AssertionError("phase 12c: prewarm incomplete, or the first dispatch "
                                     "was not a step-cache hit")
            del eng, bus
    del model
    torch.cuda.empty_cache()

    # (b) the videomae_b_long step on 2 clips.
    vspec = registry.get("videomae_b_long")
    vmodel = vspec.init_params(torch.Generator().manual_seed(0), device=dev)
    clips = [(torch.randint(0, 256, (VIDEO_STREAMS, vspec.clip_len) + FRAME_HW + (3,),
                            generator=gen, dtype=torch.uint8, device=dev),)
             for _ in range(3)]
    vengine = InferenceEngine(MemoryFrameBus(), EngineConfig(model="videomae_b_long"),
                              device=dev, model=vmodel)
    vengine.warmup()
    vstep = graphed_against_eager("b", card, vengine, build_serving_step(vmodel, vspec), clips,
                                  FRAME_HW, "flash_fwd_kernel")
    with vengine._compute_stream(), torch.inference_mode():
        replay_ms = profiled_device_ms(lambda: vstep(*clips[0]), 3, "flash_fwd_kernel")
    report["flash_attention_fwd"]["replay_ms"] = replay_ms
    log(f"phase 12b flash_attention_fwd inside a replay on {card}: {replay_ms} ms a launch "
        f"(profiler, 3 replays of {vmodel.cfg.encoder.num_layers} launches)")
    del vengine, vstep, vmodel, clips
    torch.cuda.empty_cache()


# -- phase 13: the deployment's frame path ------------------------------------------------

# One ingest worker process per camera on the shm bus, as the process
# manager starts them (the environment contract), at the north-star width.
WORKER_RUN_S = 20.0          # 13b: the engine reads the workers this long
WORKER_SLOTS = 2             # a worker's ring: max(2, in_memory_buffer + 1) slots
GATE_WINDOW_S = 2.0          # 13c: active_window_s cut from 10 s
GATE_BOTH_S = 3.0            # 13c: both streams of interest this long first
GATE_WAIT_S = 30.0           # 13c: at most this long for the keyframe-only fallback
ENGINE_LOGGER = "vep.torch.engine.runner"
FAILURE_MESSAGES = ("engine tick failed; continuing", "drain failed; continuing")


class LogCounter:
    """A ``logging.Handler`` on the engine's logger that keeps every record
    at ``level`` (ERROR) and above, so that a phase can count the failures
    the engine logged and went on from, or read the lines it logged; the
    logger lets ``level`` through while entered."""

    def __init__(self, level: int = 40):
        import logging

        class _Handler(logging.Handler):
            def emit(inner, record):
                self.records.append(record)

        self.records: list = []
        self._handler = _Handler(level=level)
        self._logger = logging.getLogger(ENGINE_LOGGER)

    def __enter__(self):
        self._level = self._logger.level
        if self._logger.getEffectiveLevel() > self._handler.level:
            self._logger.setLevel(self._handler.level)
        self._logger.addHandler(self._handler)
        return self

    def __exit__(self, *exc):
        self._logger.removeHandler(self._handler)
        self._logger.setLevel(self._level)

    def count(self, message: str) -> int:
        return sum(1 for r in self.records if r.getMessage() == message)

    def summary(self) -> str:
        out = {}
        for r in self.records:
            err = repr(r.exc_info[1])[:160] if r.exc_info else ""
            key = f"{r.getMessage()} {err}".strip()
            out[key] = out.get(key, 0) + 1
        return "; ".join(f"{n} x {k}" for k, n in out.items()) or "nothing"


def ring_dir(tag: str, need: int, phase: str = "13") -> str:
    """A fresh directory for ``need`` bytes of rings: on the /dev/shm tmpfs
    when it has the room (with a quarter more), else under the temporary
    directory (another file system runs the same code; a tmpfs that is too
    small would end a worker with SIGBUS at its first write past the limit).
    Says which and why; raises when neither has the room."""
    import tempfile

    for base, kind in (("/dev/shm", "tmpfs /dev/shm"), (tempfile.gettempdir(), "temp dir")):
        if not os.path.isdir(base):
            log(f"phase {phase}{tag} ring dir: {kind} absent")
            continue
        st = os.statvfs(base)
        free, size = st.f_bavail * st.f_frsize, st.f_blocks * st.f_frsize
        fits = free >= need * 1.25
        log(f"phase {phase}{tag} ring dir: {kind} {base} has {free} B free of {size} B; the rings "
            f"need {need} B: {'use it' if fits else 'too small'}")
        if fits:
            return tempfile.mkdtemp(prefix=f"vep_rings_{tag}_", dir=base)
    raise AssertionError(f"phase {phase}{tag}: no directory has room for {need} B of rings")


def worker_url() -> str:
    """The camera every phase-13 worker opens: the synthetic pattern at the
    north-star geometry, 30 fps, a keyframe a second."""
    return (f"test://pattern?w={FRAME_HW[1]}&h={FRAME_HW[0]}&fps={PACED_FPS:g}"
            f"&gop={int(PACED_FPS)}")


def worker_env(shm_dir: str, device_id: str) -> dict:
    """The environment a supervisor starts a port worker with."""
    return dict(os.environ, PYTHONPATH=ROOT, rtsp_endpoint=worker_url(), device_id=device_id,
                vep_shm_dir=shm_dir, vep_bus_backend="shm", in_memory_buffer="1")


def start_workers(shm_dir: str, device_ids, out_dir: str) -> dict:
    """One ``python -m video_edge_ai_proxy_tpu_torch.ingest.worker`` per
    device id, all started at once; their output goes to ``out_dir``."""
    procs = {}
    for d in device_ids:
        with open(os.path.join(out_dir, f"worker_{d}.log"), "wb") as fh:
            procs[d] = subprocess.Popen(
                [sys.executable, "-m", "video_edge_ai_proxy_tpu_torch.ingest.worker"],
                cwd=ROOT, env=worker_env(shm_dir, d), stdout=fh, stderr=subprocess.STDOUT)
    return procs


def wait_for_rings(bus, procs: dict, timeout_s: float = 120.0) -> float:
    """Until every worker has created its ring; a worker that exits first
    fails the phase. Returns the seconds it took."""
    t0 = time.monotonic()
    while set(bus.streams()) < set(procs):
        dead = {d: p.returncode for d, p in procs.items() if p.poll() is not None}
        if dead:
            raise AssertionError(f"worker processes exited before their rings were up: {dead}")
        if time.monotonic() - t0 > timeout_s:
            raise AssertionError(f"rings not up within {timeout_s:g} s: {bus.streams()}")
        time.sleep(0.05)
    return time.monotonic() - t0


def stop_workers(procs: dict, timeout_s: float = 30.0) -> dict:
    """SIGTERM every worker, wait, kill what is left; {device_id: exit code}."""
    import signal

    for p in procs.values():
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    codes = {}
    deadline = time.monotonic() + timeout_s
    for d, p in procs.items():
        try:
            codes[d] = p.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            codes[d] = f"killed after {timeout_s:g} s ({p.wait()})"
    return codes


def heartbeats(bus, device_ids) -> dict:
    """Each worker's status heartbeat (published, decoded, keyframes...)."""
    from video_edge_ai_proxy_tpu_torch.ingest.worker import KEY_STATUS_PREFIX

    out = {}
    for d in device_ids:
        raw = bus.kv_get(KEY_STATUS_PREFIX + d)
        out[d] = json.loads(raw) if raw else {}
    return out


def compute_app_pids() -> list:
    """The processes nvidia-smi lists on the card."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def cpu_seconds(pid: int) -> float:
    """User and system CPU seconds process ``pid`` has used (/proc)."""
    with open(f"/proc/{pid}/stat") as fh:
        fields = fh.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def thread_cpu_seconds(engine) -> dict:
    """CPU seconds used so far by the engine's tick, transfer and drain
    threads and by this process's main thread (/proc/self/task)."""
    threads = {"tick": engine._thread, "transfer": engine._xfer._thread,
               "drain": engine._drain_thread, "main": threading.main_thread()}
    out = {}
    for name, th in threads.items():
        tid = getattr(th, "native_id", None) if th is not None else None
        try:
            with open(f"/proc/self/task/{tid}/stat") as fh:
                fields = fh.read().rsplit(")", 1)[1].split()
            out[name] = (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")
        except (OSError, TypeError):
            out[name] = float("nan")
    return out


def thread_cores(before: dict, after: dict, wall_s: float) -> str:
    return ", ".join(f"{k} {(after[k] - before[k]) / wall_s:.3f}" for k in after)


# How late a WAKE_SLEEP_S sleep wakes: in a process of its own the sleeper
# waits only for a core; in a thread of the engine's process it waits for a
# core and then for the interpreter lock. The kernel's per-thread run-queue
# wait (/proc/<pid>/task/<tid>/schedstat) is absent on the card's machine.
WAKE_SLEEP_S = 0.005
WAKE_PROBE = ("import json, sys, time\n"
              "end, late = time.monotonic() + float(sys.argv[1]), []\n"
              "while time.monotonic() < end:\n"
              "    t = time.perf_counter()\n"
              "    time.sleep(float(sys.argv[2]))\n"
              "    late.append(time.perf_counter() - t - float(sys.argv[2]))\n"
              "print(json.dumps(late))\n")


class WakeProbe:
    """Wake-up lateness of a WAKE_SLEEP_S sleep over ``seconds``, at once in
    a process of its own (a core) and in a thread of this process (a core,
    then the interpreter lock). Its cost: 1 / WAKE_SLEEP_S wake-ups a second
    in each, the thread's each taking the lock for a few microseconds."""

    def __init__(self, seconds: float):
        self._proc = subprocess.Popen(
            [sys.executable, "-c", WAKE_PROBE, str(seconds), str(WAKE_SLEEP_S)],
            stdout=subprocess.PIPE, text=True)
        self._late: list = []
        self._end = time.monotonic() + seconds
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while time.monotonic() < self._end:
            t = time.perf_counter()
            time.sleep(WAKE_SLEEP_S)
            self._late.append(time.perf_counter() - t - WAKE_SLEEP_S)

    def result(self) -> str:
        """'process p50/p99/mean ms; engine thread p50/p99/mean ms'."""
        out, _ = self._proc.communicate(timeout=60)
        self._thread.join(60)

        def stats(late):
            late = sorted(v * 1000.0 for v in late)
            return (f"p50 {pct(late, 50):.3f}, p99 {pct(late, 99):.3f}, mean "
                    f"{statistics.fmean(late):.3f} ms over {len(late)} wake-ups")
        return (f"a process of its own {stats(json.loads(out))}; a thread of the engine's "
                f"process {stats(self._late)}")


def maps_cuda(pid: int) -> bool:
    """True when process ``pid`` has the CUDA driver library mapped."""
    try:
        with open(f"/proc/{pid}/maps") as fh:
            return "libcuda" in fh.read()
    except OSError:
        return False


def frame_path_phase(dev, card: str, zero_launches, read_launches, kernels, report,
                     pipeline: dict) -> dict:
    """Phase 13: the deployment's frame path on yolov8n bf16: (a) the replay
    folds over the shm bus, (b) 16 worker processes at 1080p read by the
    default engine for 20 s, (c) interest gating and lazy decode across 2
    worker processes, (d) log and continue on the card. Returns 13b's
    frames/s and latency percentiles."""
    import shutil
    import tempfile

    import torch

    from video_edge_ai_proxy_tpu_torch.bus.shm_bus import ShmFrameBus
    from video_edge_ai_proxy_tpu_torch.models import registry
    from video_edge_ai_proxy_tpu_torch.replay.checksum import zero_class_prior

    spec = registry.get("yolov8n")
    model = spec.init_params(torch.Generator().manual_seed(0), device=dev)
    model.load_state_dict(zero_class_prior(model.state_dict()))
    out_dir = os.path.join(ROOT, "chiprun_out", "phase13")
    os.makedirs(out_dir, exist_ok=True)
    # The ring library is built here, once, before any worker starts.
    probe_dir = tempfile.mkdtemp(prefix="vep_rings_build_")
    ShmFrameBus(probe_dir).close()
    shutil.rmtree(probe_dir, ignore_errors=True)
    shm_replay_phase(dev, card, model, pipeline)
    frame_path = worker_processes_phase(dev, card, model, out_dir, zero_launches,
                                        read_launches, kernels, report, pipeline)
    interest_phase(dev, card, model, out_dir)
    log_and_continue_phase(dev, card, model)
    del model
    torch.cuda.empty_cache()
    return frame_path


def shm_replay_phase(dev, card: str, model, pipeline: dict) -> None:
    """Phase 13a: 11a's trace through ``lockstep_checksum`` and through the
    engine's ``serve_lockstep`` over a ShmFrameBus: 11a's and 11b's folds."""
    import shutil
    import tempfile

    from video_edge_ai_proxy_tpu_torch.bus import MemoryFrameBus
    from video_edge_ai_proxy_tpu_torch.bus.shm_bus import ShmFrameBus, ring_bytes
    from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine
    from video_edge_ai_proxy_tpu_torch.replay.harness import lockstep_checksum
    from video_edge_ai_proxy_tpu_torch.replay.player import TracePlayer
    from video_edge_ai_proxy_tpu_torch.replay.recorder import record_synthetic_trace
    from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig

    streams = [f"cam{i:02d}" for i in range(N_STREAMS)]
    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    frame_bytes = FRAME_HW[0] * FRAME_HW[1] * 3
    # (a) 11a's trace over the shm bus: lockstep_checksum and the engine.
    t0 = time.perf_counter()
    rdir = ring_dir("a", N_STREAMS * ring_bytes(frame_bytes, 4))
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = record_synthetic_trace(os.path.join(tmp, "pipeline.vtrace"), streams,
                                          width=FRAME_HW[1], height=FRAME_HW[0], fps=30.0,
                                          frames=REPLAY_FRAMES)
            bus = ShmFrameBus(os.path.join(rdir, "lockstep"))
            try:
                lock = lockstep_checksum(path, model="yolov8n", device=dev, state_dict=weights,
                                         bus=bus)
            finally:
                bus.close()
                shutil.rmtree(os.path.join(rdir, "lockstep"), ignore_errors=True)
            by_packet: dict = {}
            for dev_id, frame, meta in TracePlayer(path).iter_frames():
                by_packet.setdefault(meta.packet, []).append((dev_id, frame, meta))
        ticks = [by_packet[n] for n in sorted(by_packet)]
        folds = {}
        for name in ("memory", "shm"):
            bus = (MemoryFrameBus() if name == "memory"
                   else ShmFrameBus(os.path.join(rdir, "engine")))
            try:
                engine = InferenceEngine(bus, EngineConfig(), device=dev, model=model)
                folds[name] = (engine.serve_lockstep(ticks), engine.pipeline_stats().frames)
            finally:
                bus.close()
            del engine
    finally:
        shutil.rmtree(rdir, ignore_errors=True)
    del ticks, by_packet
    log(f"phase 13a replay over the shm bus on {card}: lockstep_checksum {lock['checksum']} "
        f"over {lock['frames']} frames (11a on the memory bus: {pipeline['11a']}); the "
        f"engine's serve_lockstep {folds['shm'][0]} over {folds['shm'][1]} results (on the "
        f"memory bus in this phase {folds['memory'][0]}, 11b {pipeline['11b']}); "
        f"{time.perf_counter() - t0:.2f} s")
    if lock["checksum"] != pipeline["11a"] or lock["frames"] != N_STREAMS * REPLAY_FRAMES:
        raise AssertionError(f"phase 13a: the shm bus's lockstep fold {lock} is not 11a's "
                             f"{pipeline['11a']}")
    if not (folds["shm"] == folds["memory"] and folds["shm"][0] == pipeline["11b"]
            and folds["shm"][1] == N_STREAMS * REPLAY_FRAMES):
        raise AssertionError(f"phase 13a: the engine's folds {folds} differ from 11b's "
                             f"{pipeline['11b']}")


def worker_processes_phase(dev, card: str, model, out_dir: str, zero_launches, read_launches,
                           kernels, report, pipeline: dict) -> dict:
    """Phase 13b: one worker process per camera (16 at 1080p), read by the
    default engine through ``open_bus("shm", dir)`` for WORKER_RUN_S; the
    slice's main path, so the kernels' launch counts are read around it."""
    import shutil

    from video_edge_ai_proxy_tpu_torch.bus import open_bus
    from video_edge_ai_proxy_tpu_torch.bus.shm_bus import ring_bytes
    from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine
    from video_edge_ai_proxy_tpu_torch.obs import metrics
    from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig

    streams = [f"cam{i:02d}" for i in range(N_STREAMS)]
    frame_bytes = FRAME_HW[0] * FRAME_HW[1] * 3
    # (b) one worker process per camera, read by the default engine.
    # First, one bounded worker in a process of its own: it never touches
    # the card.
    rdir = ring_dir("b", (N_STREAMS + 1) * ring_bytes(frame_bytes, WORKER_SLOTS))
    try:
        code = ("import json, sys\n"
                "from video_edge_ai_proxy_tpu_torch.ingest import worker\n"
                "worker.main(['--max_frames', '30'])\n"
                "cuda = False\n"
                "if 'torch' in sys.modules:\n"
                "    import torch\n"
                "    cuda = torch.cuda.is_initialized()\n"
                "print(json.dumps({'torch_imported': 'torch' in sys.modules,"
                " 'cuda_initialized': cuda}))\n")
        probe = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                               env=worker_env(os.path.join(rdir, "probe"), "probe"),
                               capture_output=True, text=True, timeout=120)
        if probe.returncode != 0:
            raise AssertionError(f"phase 13b: a bounded worker failed: {probe.stderr[-2000:]}")
        probe_out = json.loads(probe.stdout.strip().splitlines()[-1])
        if probe_out["cuda_initialized"]:
            raise AssertionError(f"phase 13b: a worker initialised CUDA: {probe_out}")
        shutil.rmtree(os.path.join(rdir, "probe"), ignore_errors=True)
        log(f"phase 13b a worker process (30 frames, then exit 0): {probe_out}")

        bus = open_bus("shm", rdir)
        skipped = metrics.registry.counter("vep_frames_skipped_total", "", ("stream",))
        skipped0 = {s: skipped.labels(s).value for s in streams}
        engine = InferenceEngine(bus, EngineConfig(), device=dev, model=model)
        results = engine.subscribe(streams)
        got: dict = {}

        def consume():
            for r in results:
                got.setdefault(r.device_id, []).append(r)

        reader = threading.Thread(target=consume, daemon=True)
        reader.start()
        engine.warmup()
        idle_wake = WakeProbe(2.0).result()     # before the workers and the engine's threads
        procs = start_workers(rdir, streams, out_dir)
        try:
            up_s = wait_for_rings(bus, procs)
            with LogCounter() as logged:
                beats0 = heartbeats(bus, streams)
                cpu0 = {d: cpu_seconds(pr.pid) for d, pr in procs.items()}
                cpu0["engine"] = cpu_seconds(os.getpid())
                zero_launches()
                engine.start()
                t_start = time.monotonic()
                threads0 = thread_cpu_seconds(engine)
                probe = WakeProbe(WORKER_RUN_S)
                try:
                    time.sleep(WORKER_RUN_S / 4)
                    apps = compute_app_pids()
                    cuda_workers = [d for d, p in procs.items() if maps_cuda(p.pid)]
                    time.sleep(max(0.0, t_start + WORKER_RUN_S - time.monotonic()))
                    wall_s = time.monotonic() - t_start
                    cpu = {d: cpu_seconds(pr.pid) - cpu0[d] for d, pr in procs.items()}
                    cpu["engine"] = cpu_seconds(os.getpid()) - cpu0["engine"]
                    threads1 = thread_cpu_seconds(engine)
                    wake = probe.result()
                    beats = heartbeats(bus, streams)
                    health = engine.health()
                finally:
                    engine.stop()
                launches = read_launches()
                codes = stop_workers(procs)
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
            bus.close()
    finally:
        shutil.rmtree(rdir, ignore_errors=True)
    reader.join(10)
    p = engine.pipeline_stats()
    lat = [r.latency_ms for v in got.values() for r in v]
    dets = [d for v in got.values() for r in v for d in r.detections]
    untracked = sum(1 for d in dets if not d.track_id)
    missing = [s for s in streams if not got.get(s)]
    superseded = sum(skipped.labels(s).value - skipped0[s] for s in streams)
    published = sum(beats[s].get("published", 0) - beats0[s].get("published", 0)
                    for s in streams)
    failures = {m: logged.count(m) for m in FAILURE_MESSAGES}
    log(f"phase 13b {N_STREAMS} worker processes ({worker_url()}, rings up in {up_s:.2f} s) "
        f"read by InferenceEngine(open_bus('shm'), EngineConfig()) for {wall_s:.3f} s on "
        f"{card}: {p.frames} results ({p.frames / wall_s:.2f} frames/s), {p.batches} batches "
        f"({p.frames / max(p.batches, 1):.2f} frames per batch), {published} frames "
        f"published by the workers meanwhile (heartbeat deltas), {superseded:g} superseded "
        f"before a read, {p.shed_frames} shed")
    log(f"phase 13b capture->result latency ms on {card}: p50 {pct(lat, 50):.3f}, p95 "
        f"{pct(lat, 95):.3f}, p99 {pct(lat, 99):.3f}; mean by stage: capture->collect "
        f"{p.capture_to_collect_ms / max(p.frames, 1):.3f}, collect->submit "
        f"{p.collect_to_submit_ms / max(p.frames, 1):.3f}, submit->drained "
        f"{p.submit_to_drained_ms / max(p.frames, 1):.3f}, drained->emitted "
        f"{p.drained_to_emitted_ms / max(p.frames, 1):.3f}; the drain's emit "
        f"{p.emit_ms / max(p.frames, 1):.4f} ms a frame (tracker "
        f"{p.track_ms / max(p.frames, 1):.4f}); step spans "
        f"{p.device_ms / (wall_s * 1000.0):.4f} of the wall time")
    log(f"phase 13b beside 11c on {card} (the same engine, a publisher thread in the engine's "
        f"process): 11c {pipeline['fps']:.2f} frames/s, p50 {pipeline['p50']:.3f}, p95 "
        f"{pipeline['p95']:.3f}, p99 {pipeline['p99']:.3f}; 13b {p.frames / wall_s:.2f} "
        f"frames/s, p50 {pct(lat, 50):.3f}, p95 {pct(lat, 95):.3f}, p99 {pct(lat, 99):.3f}")
    log("phase 13b workers (published/decoded/keyframes/fps from the heartbeats): "
        + ", ".join(f"{d} {b.get('published')}/{b.get('decoded')}/{b.get('keyframes')}/"
                    f"{b.get('fps')}" for d, b in beats.items()))
    from video_edge_ai_proxy_tpu_torch.ingest.sources import SyntheticSource

    src = SyntheticSource(worker_url())
    render_ms = []
    for n in range(10):
        t0 = time.perf_counter()
        src.render(FRAME_HW[0], FRAME_HW[1], n, bg=src._bg, yy=src._yy)
        render_ms.append((time.perf_counter() - t0) * 1000.0)
    worker_cores = sum(v for d, v in cpu.items() if d != "engine") / wall_s
    log(f"phase 13b host CPU over the run ({os.cpu_count()} cores): the {len(procs)} workers "
        f"{worker_cores:.3f} cores in all ({min(v for d, v in cpu.items() if d != 'engine') / wall_s:.3f}"
        f"-{max(v for d, v in cpu.items() if d != 'engine') / wall_s:.3f} each), the engine's "
        f"process {cpu['engine'] / wall_s:.3f} cores (its threads: "
        f"{thread_cores(threads0, threads1, wall_s)}); one {FRAME_HW[1]}x{FRAME_HW[0]} pattern "
        f"render {statistics.median(render_ms):.3f} ms (median of 10, this process)")
    log(f"phase 13b a {WAKE_SLEEP_S * 1000:g} ms sleep wakes late by: before the workers "
        f"and the engine's threads, {idle_wake}; over the run, {wake}")
    log(f"phase 13b isolation: nvidia-smi compute apps {apps} (this process is pid "
        f"{os.getpid()}; worker pids {sorted(pr.pid for pr in procs.values())}); workers with "
        f"libcuda mapped: {cuda_workers}; worker exit codes at SIGTERM {sorted(set(map(str, codes.values())))}")
    log(f"phase 13b engine: {len(dets)} detections, {untracked} without a track id; logged "
        f"failures {failures} ({logged.summary()}); ladder {engine.ladder.rung}, transitions "
        f"{engine.ladder.transitions}; health ok {health['ok']}; kernel launches {launches}")
    worker_pids = {str(pr.pid) for pr in procs.values()}
    if missing:
        raise AssertionError(f"phase 13b: streams without results: {missing}")
    if not dets or untracked:
        raise AssertionError(f"phase 13b: {untracked} of {len(dets)} detections without a "
                             f"track id")
    if any(failures.values()):
        raise AssertionError(f"phase 13b: the engine logged failures: {logged.summary()}")
    if any(c != 0 for c in codes.values()):
        raise AssertionError(f"phase 13b: worker exit codes at SIGTERM {codes}")
    if cuda_workers or any(a.split(",")[0].strip() in worker_pids for a in apps):
        raise AssertionError(f"phase 13b: a worker process is on the card: {cuda_workers} {apps}")
    if not health["ok"]:
        raise AssertionError(f"phase 13b: engine unhealthy {health}")
    for name, meta in kernels.items():
        if meta["path"] == "detect":
            if launches[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched in phase 13b")
            report[name]["launches_frame_path"] = launches[name]
    del engine, got, results
    return {"fps": p.frames / wall_s, "p50": pct(lat, 50), "p95": pct(lat, 95),
            "p99": pct(lat, 99)}


def interest_phase(dev, card: str, model, out_dir: str) -> None:
    """Phase 13c: interest gating and the workers' lazy decode across 2
    worker processes, with active_window_s cut to GATE_WINDOW_S."""
    import shutil

    from video_edge_ai_proxy_tpu_torch.bus import open_bus
    from video_edge_ai_proxy_tpu_torch.bus.shm_bus import ring_bytes
    from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine
    from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig

    frame_bytes = FRAME_HW[0] * FRAME_HW[1] * 3
    # (c) interest and lazy decode across 2 worker processes.
    pair = ["gateA", "gateB"]
    rdir = ring_dir("c", len(pair) * ring_bytes(frame_bytes, WORKER_SLOTS))

    class Context:
        active = True

        def is_active(self):
            return self.active

    try:
        bus = open_bus("shm", rdir)
        engine = InferenceEngine(bus, EngineConfig(active_window_s=GATE_WINDOW_S), device=dev,
                                 model=model)
        both = Context()
        subs = {"both": engine.subscribe(pair, context=both), "A": engine.subscribe(["gateA"])}

        def consume(sub):
            for _ in sub:
                pass

        readers = [threading.Thread(target=consume, args=(sub,), daemon=True)
                   for sub in subs.values()]
        for th in readers:
            th.start()
        engine.warmup()
        procs = start_workers(rdir, pair, out_dir)
        series = []
        try:
            wait_for_rings(bus, procs)
            engine.start()
            t_start = time.monotonic()

            def sample():
                beats_c, stats = heartbeats(bus, pair), engine.stats()
                series.append((round(time.monotonic() - t_start, 2),
                               {d: beats_c[d].get("published", 0) for d in pair},
                               {d: stats[d].frames if d in stats else 0 for d in pair}))

            def rate(d, back=2):
                (t1, pub1, _), (t0_, pub0, _) = series[-1], series[-1 - back]
                return (pub1[d] - pub0[d]) / max(t1 - t0_, 1e-9)

            while time.monotonic() - t_start < GATE_BOTH_S:
                time.sleep(1.0)
                sample()
            both.active = False        # only the subscriber of gateA is left
            t_drop = time.monotonic() - t_start
            fell_back = None
            while time.monotonic() - t_start < GATE_BOTH_S + GATE_WAIT_S:
                time.sleep(1.0)
                sample()
                if len(series) > 3 and rate("gateB") <= 2.0 * PACED_FPS / int(PACED_FPS):
                    fell_back = series[-1][0]
                    break
            gated_rate = {d: rate(d) for d in pair}
            # gateB's results once its linger (and what was in flight) is over.
            gated_results = [served["gateB"] for t, _, served in series
                             if t >= t_drop + GATE_WINDOW_S + 1.0]
            # A subscriber arrives for gateB: it is inferred and kept hot at
            # the next tick.
            ticks0, stamp0 = engine.ticks, int(time.time() * 1000)
            subs["B"] = engine.subscribe(["gateB"])
            th = threading.Thread(target=consume, args=(subs["B"],), daemon=True)
            th.start()
            readers.append(th)
            deadline = time.monotonic() + 10
            while (bus.last_query_ms("gateB") or 0) < stamp0:
                if time.monotonic() > deadline:
                    raise AssertionError("phase 13c: gateB was not kept hot again")
                time.sleep(0.0005)
            back_ticks = engine.ticks - ticks0
            for _ in range(3):
                time.sleep(1.0)
                sample()
            back_rate = {d: rate(d) for d in pair}
        finally:
            engine.stop()
            codes = stop_workers(procs)
            bus.close()
    finally:
        shutil.rmtree(rdir, ignore_errors=True)
    for th in readers:
        th.join(10)
    log(f"phase 13c interest across 2 worker processes on {card}, active_window_s "
        f"{GATE_WINDOW_S:g} s (the workers' decode window 10 s): (seconds, published by each "
        f"worker, results of each stream) {series}")
    log(f"phase 13c gateB's interest dropped at {t_drop:.2f} s; it fell back to keyframes at "
        f"{fell_back} s: published/s over the last 2 s {gated_rate} (fps/gop = "
        f"{PACED_FPS / int(PACED_FPS):g}); gateB's results from its linger's end to the fall "
        f"back {gated_results}; a subscriber for gateB kept it hot again after {back_ticks} "
        f"tick(s); published/s after it {back_rate}; worker exit codes {codes}")
    if fell_back is None:
        raise AssertionError(f"phase 13c: gateB did not fall back to keyframes: {series}")
    if gated_rate["gateA"] < PACED_FPS / 2:
        raise AssertionError(f"phase 13c: gateA stopped decoding: {gated_rate}")
    if len(set(gated_results)) != 1:
        raise AssertionError(f"phase 13c: gateB was inferred while gated: {gated_results}")
    if series[-1][2]["gateB"] <= gated_results[-1]:
        raise AssertionError("phase 13c: gateB was not served after its subscriber came")
    if back_ticks > 2 or back_rate["gateB"] < PACED_FPS / 2:
        raise AssertionError(f"phase 13c: gateB did not come back within one tick: "
                             f"{back_ticks} ticks, {back_rate}")
    if any(c != 0 for c in codes.values()):
        raise AssertionError(f"phase 13c: worker exit codes at SIGTERM {codes}")
    del engine


# 13d's refused capture's pool, whose recording release_for_children ends.
REFUSED_POOLS: list = []


def release_for_children(dev) -> None:
    """End the recordings that 13d's refused capture left open, so that
    ``empty_cache`` returns this process's cached memory to the device
    before the phases that run in processes of their own (19-23)."""
    import torch

    from video_edge_ai_proxy_tpu_torch.engine import runner

    before = torch.cuda.memory_reserved(dev)
    for pool in REFUSED_POOLS:
        runner._end_pool_recording(dev, pool)
    REFUSED_POOLS.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(dev)
    log(f"before phase 19: {before / 2 ** 20:.1f} MiB reserved, "
        f"{torch.cuda.memory_reserved(dev) / 2 ** 20:.1f} MiB after the release; the card's "
        f"free memory {free / 2 ** 30:.2f} GiB of {total / 2 ** 30:.2f} GiB")


def log_and_continue_phase(dev, card: str, model) -> None:
    """Phase 13d: three injected collect failures, then a capture failure
    confined to one geometry key, on the card."""
    import numpy as np
    import torch

    from video_edge_ai_proxy_tpu_torch.bus import MemoryFrameBus
    from video_edge_ai_proxy_tpu_torch.bus.interface import FrameMeta
    from video_edge_ai_proxy_tpu_torch.engine import runner
    from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine
    from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig

    frame_bytes = FRAME_HW[0] * FRAME_HW[1] * 3
    # (d) log and continue on the card.
    pool = [np.ascontiguousarray(np.broadcast_to(
        np.uint8(40 * i), FRAME_HW + (3,))) for i in range(4)]
    bus = MemoryFrameBus()
    bus.create_stream("cam00", frame_bytes)
    engine = InferenceEngine(bus, EngineConfig(), device=dev, model=model)
    orig_collect = engine._collector.collect
    calls = {"n": 0}

    def flaky(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] <= 3:
            raise RuntimeError("injected tick failure")
        return orig_collect(*args, **kwargs)

    engine._collector.collect = flaky
    results = engine.subscribe(["cam00"])
    got_d: list = []
    reader = threading.Thread(target=lambda: got_d.extend(results), daemon=True)
    reader.start()
    with LogCounter() as logged:
        engine.start()
        try:
            deadline = time.monotonic() + 60
            n = 0
            while len(got_d) < 5:
                if time.monotonic() > deadline:
                    raise AssertionError("phase 13d: no results after the injected failures")
                bus.publish("cam00", pool[n % 4], FrameMeta(width=FRAME_HW[1],
                                                            height=FRAME_HW[0], packet=n,
                                                            timestamp_ms=int(time.time() * 1000)))
                n += 1
                time.sleep(1.0 / PACED_FPS)
            health = engine.health()
        finally:
            engine.stop()
    reader.join(10)
    tick_failed = logged.count(FAILURE_MESSAGES[0])
    log(f"phase 13d three collect failures on {card}: logged {logged.summary()}; then "
        f"{len(got_d)} results; health ok {health['ok']}; stop() did not raise")
    if calls["n"] <= 3 or tick_failed != 3 or not health["ok"]:
        raise AssertionError(f"phase 13d: {calls['n']} collects, {tick_failed} logged tick "
                             f"failures, health {health}")
    del engine

    # A capture that fails for one geometry: a synchronising read inside
    # the step is refused while the graph is captured. The failing key
    # (720p) sorts before the served one (1080p), and both are published in
    # the same ticks.
    fail_hw, ok_hw = (720, 1280), FRAME_HW
    build = runner.build_serving_step
    eager_calls = {"n": 0}

    def breaking(model_, spec_, **kw):
        step = build(model_, spec_, **kw)

        def run(frames, *rest):
            out = step(frames, *rest)
            if tuple(frames.shape[1:3]) == fail_hw:
                eager_calls["n"] += not torch.cuda.is_current_stream_capturing()
                out["boxes"].sum().item()
            return out
        return run

    bus = MemoryFrameBus()
    bus.create_stream("fail", fail_hw[0] * fail_hw[1] * 3)
    bus.create_stream("ok", frame_bytes)
    engine = InferenceEngine(bus, EngineConfig(), device=dev, model=model)
    results = engine.subscribe(["fail", "ok"])
    got_c: dict = {}
    reader = threading.Thread(target=lambda: [got_c.setdefault(r.device_id, []).append(r)
                                              for r in results], daemon=True)
    reader.start()
    dispatch = engine._dispatch
    shared = {"ticks": 0, "served": 0}

    def counted(groups, *args, **kwargs):
        both = {d for g in groups for d in g.device_ids} >= {"fail", "ok"}
        before = engine._pipe.batches
        dispatch(groups, *args, **kwargs)
        shared["ticks"] += both
        shared["served"] += both and engine._pipe.batches > before
    engine._dispatch = counted
    frames = {"fail": np.full(fail_hw + (3,), 60, np.uint8),
              "ok": np.full(ok_hw + (3,), 90, np.uint8)}

    def publish_both(n):
        for d, f in frames.items():
            bus.publish(d, f, FrameMeta(width=f.shape[1], height=f.shape[0], packet=n))

    runner.build_serving_step = breaking
    try:
        with LogCounter() as logged:
            engine.start()
            try:
                n = 0
                deadline = time.monotonic() + 60
                while len(got_c.get("ok", [])) < 3:
                    if time.monotonic() > deadline:
                        raise AssertionError("phase 13d: the second geometry did not serve")
                    publish_both(n)
                    n += 1
                    time.sleep(1.0 / PACED_FPS)
                first = engine.graph_stats()
                # What the repair avoids: the failed capture's pool.
                old_pool = engine._graph_pools[0]
                side = torch.cuda.Stream(dev)
                try:
                    # The outer stream context restores this thread's stream
                    # when the capture's own context is left half entered.
                    with torch.cuda.stream(side), torch.cuda.graph(
                            torch.cuda.CUDAGraph(), pool=old_pool, stream=side,
                            capture_error_mode="thread_local"):
                        torch.zeros(4, device=dev).add_(1)
                    old_pool_state = "still captures"
                except Exception as exc:   # a capture into it raises
                    old_pool_state = f"refuses a capture: {str(exc).splitlines()[0][:160]}"
                    # The refused capture leaves the allocator recording into
                    # the pool, so no empty_cache of this process releases
                    # anything until release_for_children ends it before
                    # phase 19. Ended here, each later capture's empty_cache
                    # returns the cache to the device, and phase 14's server
                    # then served too slowly to fill its audit capture.
                    REFUSED_POOLS.append(old_pool)
                torch.cuda.synchronize()
                # The failing key keeps coming, for GATE_BOTH_S more.
                failed0 = logged.count(FAILURE_MESSAGES[0])
                t_end = time.monotonic() + GATE_BOTH_S
                while time.monotonic() < t_end:
                    publish_both(n)
                    n += 1
                    time.sleep(1.0 / PACED_FPS)
                last = engine.graph_stats()
                failed_more = logged.count(FAILURE_MESSAGES[0]) - failed0
                health = engine.health()
            finally:
                engine.stop()
    finally:
        runner.build_serving_step = build
    reader.join(10)
    log(f"phase 13d a capture failure for {fail_hw[1]}x{fail_hw[0]} on {card}, published in "
        f"the same ticks as {ok_hw[1]}x{ok_hw[0]}: logged {logged.summary()}; the failed "
        f"capture's pool {old_pool_state}; {ok_hw[1]}x{ok_hw[0]} served "
        f"{len(got_c.get('ok', []))} results, {shared['served']} of them in the "
        f"{shared['ticks']} ticks that held both keys; results of the failed key "
        f"{len(got_c.get('fail', []))} (its eager warmup calls before the capture: "
        f"{eager_calls['n']}); graphs after the first results {first}, {GATE_BOTH_S:g} s and "
        f"{failed_more} more failed batches later {last}; health ok {health['ok']}")
    if (got_c.get("fail") or eager_calls["n"] != runner._GraphedStep.WARMUP_CALLS
            or shared["served"] < 3 or failed_more < 3 or not health["ok"]):
        raise AssertionError("phase 13d: the failed capture was not confined to its key")
    if (first["programs"], first["pools"]) != (1, 2) or \
            (last["programs"], last["pools"], last["pool_bytes"]) != (1, 2, first["pool_bytes"]):
        raise AssertionError(f"phase 13d: a failing key took more pools: {first} then {last}")
    del engine


# -- phase 14: the server's planes -------------------------------------------------------

SERVER_MODEL = "yolov8n"     # 14: the default model (EngineConfig's)
SERVER_EXTRA_MODEL = "vit_b16"   # 14: one camera's own model
SERVER_RUN_S = 20.0          # 14: the engine serves the 16 cameras this long
SERVER_AFTER_RESUME_S = 10.0  # 14: served this much more after the re-adopting restart
# 14: the captures of the second server's window (ms): one over REST, one
# over gRPC, two at once over REST (one must answer 409); the lineage
# tracer samples 1 frame in TRACE_EVERY there (obs.trace is off as shipped).
CAPTURE_REST_MS, CAPTURE_GRPC_MS, CAPTURE_PAIR_MS = 500, 300, 500
TRACE_EVERY = 16
NMS_KERNEL = "nms_keep_mask_kernel"
EDGE_KEY, EDGE_SECRET = "edge-key-14", "edge-secret-14"
WIRE_PACKAGES = ("grpc", "google.protobuf", "aiohttp", "yaml")


class AnnotationSink:
    """A stdlib HTTP server on 127.0.0.1 that records every POST: the
    path, the JSON events and whether the signature header verifies with
    EDGE_SECRET."""

    def __init__(self):
        import http.server

        from video_edge_ai_proxy_tpu_torch.utils.signing import verify_signature

        posts = self.posts = []

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                head = {"X-ChrysEdge-Auth": self.headers.get("X-ChrysEdge-Auth", ""),
                        "X-Chrys-Date": self.headers.get("X-Chrys-Date", ""),
                        "Content-MD5": self.headers.get("Content-MD5", "")}
                posts.append((self.path, json.loads(body),
                               verify_signature(body, head, EDGE_SECRET)))
                self.send_response(200)
                self.end_headers()
                self.wfile.write(b"{}")

            do_PUT = do_POST

            def log_message(self, *_a):
                pass

        self._httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self._httpd.server_port}"
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(10)


def server_cameras() -> dict:
    """The 16 cameras of phase 14: name -> (inference_model, annotation_policy)."""
    cams = {f"cam{i:02d}": ("", "") for i in range(N_STREAMS - 2)}
    # In the half the ladder's admission_pause keeps admitted (sorted first).
    cams["cam01"] = ("", "keyframe")
    cams["vit00"] = (SERVER_EXTRA_MODEL, "")
    cams["off00"] = ("none", "")
    return cams


def worker_limits(pid: int) -> str:
    """'<RLIMIT_AS soft> B, nice <n>' of process ``pid`` (/proc)."""
    with open(f"/proc/{pid}/limits") as fh:
        line = next(ln for ln in fh if ln.startswith("Max address space"))
    with open(f"/proc/{pid}/stat") as fh:
        nice = int(fh.read().rsplit(")", 1)[1].split()[16])
    return f"{line.split()[3]} B, nice {nice}"


def adoption_checks(pid: int, starttime, device_id: str) -> str:
    """What re-adoption reads of a recorded worker: its /proc stat field 22
    against the recorded birth tick, the worker module in its cmdline, its
    device_id in its environ."""
    from video_edge_ai_proxy_tpu_torch.serve.process_manager import WORKER_MODULE, _proc_starttime

    out = [f"starttime {_proc_starttime(pid)} (recorded {starttime})"]
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as fh:
            out.append(f"cmdline has the module {WORKER_MODULE.encode() in fh.read().split(bytes(1))}")
        with open(f"/proc/{pid}/environ", "rb") as fh:
            env = dict(p.split(b"=", 1) for p in fh.read().split(bytes(1)) if b"=" in p)
        out.append(f"environ device_id {env.get(b'device_id', b'').decode()!r}")
    except OSError as exc:
        out.append(f"/proc unreadable: {exc!r}")
    return "; ".join(out)


def annotation_device(payload: bytes) -> str:
    """The device_name of an AnnotateRequest's wire bytes: field 1, written
    first when set (tag 0x0a, a one-byte length for names under 128 B)."""
    if payload[:1] != b"\x0a" or payload[1] > 0x7F:
        return ""
    return payload[2:2 + payload[1]].decode("utf-8", "replace")


def count_offered(queue) -> dict:
    """Count each event the queue is offered by device: {device: [accepted,
    shed at the unacked limit]}, by wrapping its publish."""
    counts: dict = {}
    publish = queue.publish

    def counted(payload: bytes) -> bool:
        ok = publish(payload)
        counts.setdefault(annotation_device(payload), [0, 0])[0 if ok else 1] += 1
        return ok

    queue.publish = counted
    return counts


def run_server(cfg, data_dir: str, model_state: dict, cams: dict, *, register: bool,
               serve_s: float, wire: bool = False, zero_launches=None, read_launches=None,
               on_serving=None):
    """One ``Server`` with the phase's weights, started in start()'s order:
    its card-side planes (resume, cron, the annotation consumer, the
    engine), or with ``wire`` the whole ``Server.start()`` (REST and gRPC
    on ephemeral ports too). Registers ``cams`` when asked, subscribes to
    all of them and serves ``serve_s`` after every ring is up.
    ``on_serving(srv, got, out)`` runs at the end of the window, before the
    server stops. Returns a dict of what was seen."""
    from video_edge_ai_proxy_tpu_torch.serve import StreamProcess
    from video_edge_ai_proxy_tpu_torch.serve.server import Server

    srv = Server(cfg, data_dir=data_dir, enable_engine=True, grpc_port=0, rest_port=0)
    out: dict = {"server": srv, "offered": count_offered(srv.annotations)}
    try:
        srv.settings.overwrite(EDGE_KEY, EDGE_SECRET)
        srv.engine.warmup()
        srv.engine._model.load_state_dict(model_state)
        # The counts are zeroed before the engine starts: a reset while a
        # graph is being captured would corrupt the launches the capture
        # records for its replays.
        if zero_launches is not None:
            zero_launches()
        t_boot = out["t_boot"] = time.monotonic()
        if wire:
            srv.start()
        else:
            srv.process_manager.resume()
            srv.cron.start()
            srv.annotations.start()
            srv.engine.start()
        out["resumed"] = len(srv.process_manager.device_ids())
        out["start_s"] = time.monotonic() - t_boot
        if register:
            for name, (model, policy) in cams.items():
                srv.process_manager.start(StreamProcess(
                    name=name, rtsp_endpoint=worker_url(), inference_model=model,
                    annotation_policy=policy))
        got: dict = {}
        results = srv.engine.subscribe(list(cams))
        reader = threading.Thread(target=lambda: [got.setdefault(r.device_id, []).append(
            (time.monotonic(), r)) for r in results], daemon=True)
        reader.start()
        t_wait = time.monotonic()
        while set(srv.bus.streams()) < set(cams):
            if time.monotonic() - t_wait > 120:
                raise AssertionError(f"phase 14: rings not up within 120 s: {srv.bus.streams()}")
            time.sleep(0.05)
        out["rings_s"] = time.monotonic() - t_boot
        beats0 = heartbeats(srv.bus, cams)
        pids = {d: srv.process_manager.info(d).state.pid for d in cams}
        cpu0 = {d: cpu_seconds(p) for d, p in pids.items()}
        cpu0["server"] = cpu_seconds(os.getpid())
        p0 = srv.engine.pipeline_stats()
        # The per-tick watch work, timed from here: (monotonic, µs) a call.
        watch_us = out["watch_us"] = []
        watch_tick = srv.engine._watch_tick

        def timed_watch(*args):
            t_in = time.perf_counter()
            try:
                return watch_tick(*args)
            finally:
                watch_us.append((time.monotonic(), (time.perf_counter() - t_in) * 1e6))

        srv.engine._watch_tick = timed_watch
        t0 = time.monotonic()
        out["t0_wall"] = time.time()
        threads0 = thread_cpu_seconds(srv.engine)
        probe = WakeProbe(serve_s)
        time.sleep(serve_s / 4)
        out["cuda_workers"] = [d for d, p in pids.items() if maps_cuda(p)]
        out["limits"] = sorted({worker_limits(p) for p in pids.values()})
        time.sleep(max(0.0, t0 + serve_s - time.monotonic()))
        wall_s = time.monotonic() - t0
        out["launches"] = read_launches() if read_launches is not None else None
        out["journal_window"] = [e for e in (srv.journal.events() if srv.journal else [])
                                 if out["t0_wall"] <= e["ts"] <= out["t0_wall"] + wall_s]
        out["watch_window_us"] = [us for t, us in watch_us if t0 <= t <= t0 + wall_s]
        out.update(wall_s=wall_s, t0=t0, got=got, pids=pids, wake=probe.result(),
                   threads=thread_cores(threads0, thread_cpu_seconds(srv.engine), wall_s),
                   beats0=beats0, beats=heartbeats(srv.bus, cams), p0=p0,
                   p1=srv.engine.pipeline_stats(), health=srv.engine.health(),
                   cpu={d: cpu_seconds(p) - cpu0[d] for d, p in pids.items()},
                   cpu_server=cpu_seconds(os.getpid()) - cpu0["server"])
        if on_serving is not None:
            on_serving(srv, got, out)
        out["runtime"] = {d: srv.process_manager.info(d).runtime for d in cams}
    finally:
        srv.stop()
    reader.join(10)
    return out


def wire_check(srv, sink) -> dict:
    """The running server's wire: gRPC ListStreams, three Inference results
    of cam00 (boxed, tracked, the frame's trace id echoed), one VideoLatestImage frame and an acked Annotate (whether it
    reached the sink is reported, not checked: under the engine's own
    annotation load the queue may shed it); REST /healthz, /api/v1/stats
    and /metrics."""
    import urllib.request

    import grpc

    from video_edge_ai_proxy_tpu_torch.proto import video_streaming_pb2 as pb
    from video_edge_ai_proxy_tpu_torch.proto import video_streaming_pb2_grpc as pb_grpc

    rest = f"http://127.0.0.1:{srv._rest.bound_port}"
    out: dict = {"grpc_port": srv.bound_grpc_port, "rest_port": srv._rest.bound_port}
    with grpc.insecure_channel(f"127.0.0.1:{srv.bound_grpc_port}",
                               options=[("grpc.max_receive_message_length", 64 << 20)]) as ch:
        stub = pb_grpc.ImageStub(ch)
        listed = list(stub.ListStreams(pb.ListStreamRequest(), timeout=30))
        out["list_streams"] = {"n": len(listed), "running": sum(s.running for s in listed)}
        results = []
        for r in stub.Inference(pb.InferenceRequest(device_ids=["cam00"]), timeout=30):
            results.append(r)
            if len(results) == 3:
                break
        out["inference"] = [(r.model, len(r.detections),
                             all(d.HasField("box") and d.track_id for d in r.detections),
                             r.trace_id != 0) for r in results]

        def one_frame():
            yield pb.VideoFrameRequest(device_id="cam00")

        frame = next(iter(stub.VideoLatestImage(one_frame(), timeout=30)))
        out["frame"] = (frame.width, frame.height, len(frame.data))
        ts = int(time.time() * 1000)
        ack = stub.Annotate(pb.AnnotateRequest(device_name="cam00", type="wire-check",
                                               start_timestamp=ts), timeout=30)
        out["annotate_ack"] = (ack.device_name, ack.type, ack.start_timestamp) == (
            "cam00", "wire-check", ts)
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and not any(
            e.get("type") == "wire-check" for _, body, _ in list(sink.posts) for e in body):
        time.sleep(0.1)
    out["annotate_at_sink"] = any(e.get("type") == "wire-check" and ok
                                  for _, body, ok in list(sink.posts) for e in body)
    with urllib.request.urlopen(rest + "/healthz", timeout=30) as resp:
        out["healthz"] = resp.status
    with urllib.request.urlopen(rest + "/api/v1/stats", timeout=30) as resp:
        out["stats_streams"] = len(json.loads(resp.read())["engine"]["streams"])
    with urllib.request.urlopen(rest + "/metrics", timeout=30) as resp:
        out["metrics_workers"] = b"vep_workers_total 16" in resp.read()
    out["ok"] = (out["list_streams"]["n"] == N_STREAMS and len(results) == 3
                 and all(m == SERVER_MODEL and ok and traced
                         for m, _, ok, traced in out["inference"])
                 and out["frame"] == (FRAME_HW[1], FRAME_HW[0], FRAME_HW[0] * FRAME_HW[1] * 3)
                 and out["annotate_ack"] and out["healthz"] == 200
                 and out["metrics_workers"])
    return out


def trace_kernels(path: str) -> dict:
    """{kernel name: events} of the device kernels in a bundle's Chrome
    trace (torch.profiler's ``export_chrome_trace``)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out: dict = {}
    for ev in events:
        if ev.get("cat") == "kernel":
            out[ev["name"]] = out.get(ev["name"], 0) + 1
    return out


def stage_legs(events) -> dict:
    """Per-leg samples (ms) of lineage spans, folded as ``obs/spans.py``
    ``stage_breakdown`` folds them (its table gives p50/p90/p99; this one
    keeps the samples for p95): publish -> collect (the collect span's
    ``pub_ms``, the worker's grab), collect -> submit, the device span,
    the drain's end -> emit, and publish -> emit."""
    lineages: dict = {}
    for ev in events:
        lineages.setdefault((ev.get("stream"), ev.get("frame")), {})[ev.get("stage")] = ev
    legs: dict = {k: [] for k in ("publish->collect", "collect->submit", "device (drain)",
                                  "drain->emit", "publish->emit")}
    for st in lineages.values():
        col, sub, dev_, emit = (st.get(k) for k in ("collect", "submit", "device", "emit"))
        pub = col.get("pub_ms") if col is not None else None
        if pub is not None:
            legs["publish->collect"].append(col["ts"] * 1000.0 - pub)
        if col is not None and sub is not None:
            legs["collect->submit"].append((sub["ts"] - col["ts"]) * 1000.0)
        if dev_ is not None and dev_.get("dur_ms") is not None:
            legs["device (drain)"].append(float(dev_["dur_ms"]))
        if dev_ is not None and emit is not None:
            legs["drain->emit"].append((emit["ts"] - dev_["ts"]) * 1000.0)
        if pub is not None and emit is not None:
            legs["publish->emit"].append(emit["ts"] * 1000.0 - pub)
    return legs


def audit_check(srv, got: dict, nms_wrapper) -> dict:
    """The audit and profiling planes of the running server, while its
    cameras are served: a REST capture of CAPTURE_REST_MS, a gRPC
    ``vep.Admin/ProfileCapture`` of CAPTURE_GRPC_MS, two REST captures at
    once (one must answer 409); each bundle's manifest, device trace
    (its kernel events, the keep mask's beside the batches stepped and
    the keep-mask launches during the call), spans and journal files,
    and the results/s inside its window beside the same length just
    before; the journal, the ladder's ``why`` chain and the lineage
    spans' legs. Returns what was seen, with ``problems``."""
    import urllib.error
    import urllib.request

    import grpc

    rest = f"http://127.0.0.1:{srv._rest.bound_port}"
    pm = srv.process_manager
    pids0 = {d: pm.info(d).state.pid for d in pm.device_ids()}
    out: dict = {"captures": [], "problems": []}

    def get(path):
        with urllib.request.urlopen(rest + path, timeout=120) as resp:
            return json.loads(resp.read())

    def post_capture(ms):
        req = urllib.request.Request(f"{rest}/api/v1/profile?ms={ms}", method="POST")
        try:
            with urllib.request.urlopen(req, timeout=600) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as err:
            return err.code, json.loads(err.read())

    def grpc_capture(ms):
        with grpc.insecure_channel(f"127.0.0.1:{srv.bound_grpc_port}") as ch:
            raw = ch.unary_unary("/vep.Admin/ProfileCapture")(
                json.dumps({"ms": ms}).encode(), timeout=600)
        return 200, json.loads(raw)

    def results_between(a, b):
        return sum(1 for v in list(got.values()) for t, _ in list(v) if a <= t < b)

    def capture(via, fn):
        m0, w0 = time.monotonic(), time.time()
        b0, l0 = srv.engine.pipeline_stats().batches, nms_wrapper.launches
        status, man = fn()
        rec = {"via": via, "status": status, "call_s": time.monotonic() - m0,
               "batches": srv.engine.pipeline_stats().batches - b0,
               "nms_launches": nms_wrapper.launches - l0}
        if status != 200:
            rec["answer"] = man
            return rec
        rec.update(bundle=man["bundle"], ms=man["ms"], wall_ms=man["wall_ms"],
                   error=man["error"], device_trace=man["device_trace"],
                   span_events=man["span_events"], journal_events=man["journal_events"])
        a = m0 + (man["t_start"] - w0)
        dur = max(man["t_end"] - man["t_start"], 1e-6)
        rec["fps_in"] = results_between(a, a + dur) / dur
        rec["fps_before"] = results_between(a - dur, a) / dur
        rec["files"] = {name: os.path.isfile(os.path.join(man["path"], name))
                        for name in ("spans.json", "journal.json", "snapshot.json")}
        if man["device_trace"]:
            try:
                kinds = trace_kernels(os.path.join(man["path"], man["device_trace"]))
                rec["kernel_events"] = sum(kinds.values())
                rec["kernel_kinds"] = len(kinds)
                rec["nms_events"] = sum(n for k, n in kinds.items() if NMS_KERNEL in k)
                rec["trace_bytes"] = os.path.getsize(os.path.join(man["path"],
                                                                  man["device_trace"]))
            except (OSError, ValueError, KeyError) as exc:
                rec["parse_error"] = repr(exc)
        if man["error"] is not None:
            out["problems"].append(f"{via}: manifest error {man['error']}")
        elif not man["device_trace"] or "parse_error" in rec:
            out["problems"].append(f"{via}: no device trace, or it does not parse: {rec}")
        elif not rec.get("nms_events"):
            out["problems"].append(f"{via}: no {NMS_KERNEL} event among "
                                   f"{rec.get('kernel_events')} kernel events")
        if not all(rec["files"].values()):
            out["problems"].append(f"{via}: bundle files missing {rec['files']}")
        return rec

    out["captures"].append(capture("rest", lambda: post_capture(CAPTURE_REST_MS)))
    out["captures"].append(capture("grpc", lambda: grpc_capture(CAPTURE_GRPC_MS)))
    pair: list = [None, None]
    threads = [threading.Thread(target=lambda i=i: pair.__setitem__(
        i, capture(f"rest pair {i}", lambda: post_capture(CAPTURE_PAIR_MS)))) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    out["captures"] += [p for p in pair if p is not None]
    statuses = sorted(p["status"] for p in pair if p is not None)
    out["pair_statuses"] = statuses
    if statuses != [200, 409]:
        out["problems"].append(f"the concurrent captures answered {statuses}, not 200 and 409")
    if [c["status"] for c in out["captures"][:2]] != [200, 200]:
        out["problems"].append("the REST or gRPC capture did not answer 200")
    pids1 = {d: pm.info(d).state.pid for d in pm.device_ids()}
    out["respawned_during"] = {d: (pids0[d], pids1.get(d)) for d in pids0
                               if pids1.get(d) != pids0[d]}
    journal = get("/api/v1/journal")
    actions: dict = {}
    for ev in journal["events"]:
        key = f"{ev['actor']}.{ev['action']}"
        actions[key] = actions.get(key, 0) + 1
    out["journal"] = {"next_seq": journal["next_seq"], "by_action": actions}
    why = get("/api/v1/why?subject=ladder:engine")
    chain = why["chain"]
    out["why"] = {"links": why["links"], "text": why["text"],
                  "escalates": sum(1 for e in chain if e["action"] == "escalate"),
                  "roots_at_slo": bool(chain) and (chain[0]["actor"], chain[0]["action"])
                  == ("slo", "episode_open"),
                  "rung": srv.engine.ladder.rung}
    if not out["why"]["escalates"]:
        out["problems"].append(f"the ladder's why chain has no escalate link: {why['text']}")
    trace = get("/api/v1/trace")
    legs = stage_legs(trace["events"])
    out["trace"] = {"enabled": trace["enabled"], "sample_every": trace["sample_every"],
                    "events": len(trace["events"]),
                    "legs": {k: (len(v), pct(v, 50) if v else None, pct(v, 95) if v else None)
                             for k, v in legs.items()}}
    if not legs["publish->emit"]:
        out["problems"].append("no complete lineage among the sampled spans")
    return out


def server_phase(dev, card: str, zero_launches, read_launches, kernels, report,
                 frame_path: dict) -> None:
    """Phase 14: the default ``Server``'s planes around the engine on the
    card: 16 cameras registered through its process manager (14 on
    yolov8n, one of them with the keyframe annotation policy, one on
    vit_b16, one with inference off), the annotation uplink posting to a
    local sink, one subscriber for SERVER_RUN_S; then a SIGKILLed worker
    restarted, and a stop (workers detached) and a new ``Server`` on the
    same data dir that re-adopts them, served SERVER_AFTER_RESUME_S more,
    with the wire when this machine has its packages, and the audit and
    profiling planes checked over it (``audit_check``). The slice's main
    path: the kernels' launch counts are zeroed before the first server's
    engine starts and read after its window, which runs without the wire,
    as 13b does."""
    import importlib
    import shutil
    import signal
    import tempfile

    import torch

    from video_edge_ai_proxy_tpu_torch.bus.shm_bus import ring_bytes
    from video_edge_ai_proxy_tpu_torch.models import registry
    from video_edge_ai_proxy_tpu_torch.replay.checksum import zero_class_prior
    from video_edge_ai_proxy_tpu_torch.utils.config import Config

    found = {}
    for m in WIRE_PACKAGES:
        try:
            found[m] = getattr(importlib.import_module(m), "__version__", "?")
        except ImportError as exc:
            found[m] = f"absent ({exc})"
    wire = all(not str(v).startswith("absent") for k, v in found.items() if k != "yaml")
    log(f"phase 14 the wire's packages on this machine: {found}; the first server drives "
        f"its planes in start()'s order without REST and gRPC (the window beside 13b); the "
        + ("second runs the whole Server.start(), the wire on ephemeral ports, and checks it"
           if wire else "second too: without them Server.start() raises ImportError"))
    cams = server_cameras()
    default = [d for d, (m, _) in cams.items() if m == ""]
    kf_cam = next(d for d, (_, p) in cams.items() if p == "keyframe")
    model_state = zero_class_prior(registry.get(SERVER_MODEL).init_params(
        torch.Generator().manual_seed(0), device=dev).state_dict())
    frame_bytes = FRAME_HW[0] * FRAME_HW[1] * 3
    rdir = ring_dir("", (len(cams) + 1) * ring_bytes(frame_bytes, WORKER_SLOTS), phase="14")
    data_dir = tempfile.mkdtemp(prefix="vep_server_")
    sink = AnnotationSink()
    cfg = Config()
    cfg.bus.shm_dir = rdir
    cfg.annotation.endpoint = sink.url + "/api/v1/annotate"
    cfg.api.endpoint = sink.url
    cfg.engine.slo_warmup_s = 3.0
    kill: dict = {}

    def restart_check(srv, got, out):
        """SIGKILL one default camera's worker; the supervisor respawns it
        with failing_streak 1 and the OOM flag; results resume."""
        pm = srv.process_manager
        victim = default[0]
        pid = pm.info(victim).state.pid
        t_kill = time.monotonic()
        os.kill(pid, signal.SIGKILL)
        deadline = t_kill + 60
        while time.monotonic() < deadline:
            st = pm.info(victim).state
            if st.running and st.pid != pid:
                break
            time.sleep(0.05)
        st = pm.info(victim).state
        t_respawn, wall_respawn_ms = time.monotonic(), time.time() * 1000.0

        def back():
            return [t for t, r in list(got.get(victim, [])) if r.timestamp >= wall_respawn_ms]

        while time.monotonic() < deadline and not back():
            time.sleep(0.05)
        back = back()
        kill.update(victim=victim, pid=pid, new_pid=st.pid, running=st.running,
                    streak=st.failing_streak, oom=st.oom_killed,
                    respawn_s=t_respawn - t_kill,
                    results_s=(back[0] - t_kill) if back else None)

    # The queue logs every 100th annotation it sheds past its unacked
    # limit; the phase prints the count instead.
    import logging

    queue_log = logging.getLogger("vep.torch.uplink.queue")
    queue_level = queue_log.level
    queue_log.setLevel(logging.ERROR)
    try:
        with LogCounter() as logged:
            first = run_server(cfg, data_dir, model_state, cams, register=True,
                               serve_s=SERVER_RUN_S, zero_launches=zero_launches,
                               read_launches=read_launches, on_serving=restart_check)
            eng1 = first["server"].engine
            graphs1 = eng1.graph_stats()
            keys1 = sorted(k[0] for k in eng1._steps)
            spool = first["server"].annotations._handler.spool.snapshot()
            ann = first["server"].annotations
            ann_counts = {"published": ann.published, "acked": ann.acked,
                          "dropped": ann.dropped, "depth": ann.depth(),
                          "suppressed": eng1.annotations_suppressed}
            del eng1
            first["server"] = None
            torch.cuda.empty_cache()
            posts_first = len(sink.posts)
            recorded = {d: (rt or {}).get("pid") for d, rt in first["runtime"].items()}
            starts = {d: (rt or {}).get("starttime") for d, rt in first["runtime"].items()}
            alive = [d for d, p in recorded.items() if p and os.path.exists(f"/proc/{p}")]
            # What re-adoption will read of each detached worker.
            why = {d: adoption_checks(p, starts[d], d) for d, p in recorded.items() if p}
            # The second server samples lineage spans (obs.trace, off as
            # shipped) for the audit check's stage legs.
            cfg.obs.trace, cfg.obs.sample_every = True, TRACE_EVERY
            nms_wrapper = kernels["nms_keep_mask"]["wrapper"]
            second = run_server(cfg, data_dir, model_state, cams, register=False,
                                serve_s=SERVER_AFTER_RESUME_S, wire=wire,
                                on_serving=lambda srv, got, out: (
                                    wire and out.update(wire=wire_check(srv, sink)),
                                    wire and out.update(audit=audit_check(srv, got, nms_wrapper)),
                                    srv.process_manager.shutdown_workers()))
            second["server"] = None
            torch.cuda.empty_cache()
    finally:
        from video_edge_ai_proxy_tpu_torch.obs import tracer

        tracer.configure(enabled=False)
        tracer.clear()
        queue_log.setLevel(queue_level)
        sink.close()
        shutil.rmtree(rdir, ignore_errors=True)
        shutil.rmtree(data_dir, ignore_errors=True)

    # -- the first window ---------------------------------------------------------------
    got, wall_s = first["got"], first["wall_s"]
    p0, p1 = first["p0"], first["p1"]
    window = {d: [r for t, r in v if first["t0"] <= t <= first["t0"] + wall_s]
              for d, v in got.items()}
    by_model: dict = {}
    for d, rs in window.items():
        for r in rs:
            by_model.setdefault(r.model, []).append(r)
    for model, rs in sorted(by_model.items()):
        lat = [r.latency_ms for r in rs]
        log(f"phase 14 {model} on {card}: {len(rs)} results in {wall_s:.3f} s "
            f"({len(rs) / wall_s:.2f} frames/s), latency ms p50 {pct(lat, 50):.3f}, p95 "
            f"{pct(lat, 95):.3f}, p99 {pct(lat, 99):.3f}")
    lat_all = [r.latency_ms for rs in window.values() for r in rs]
    frames = sum(len(v) for v in window.values())
    log(f"phase 14 beside 13b on {card}: 13b {frame_path['fps']:.2f} frames/s, p50 "
        f"{frame_path['p50']:.3f}, p95 {frame_path['p95']:.3f}, p99 {frame_path['p99']:.3f}; "
        f"14 (16 cameras, {len(default)} on yolov8n, one vit_b16, one off) "
        f"{frames / wall_s:.2f} frames/s, p50 {pct(lat_all, 50):.3f}, p95 "
        f"{pct(lat_all, 95):.3f}, p99 {pct(lat_all, 99):.3f}")
    log("phase 14 results per camera in the window: "
        + ", ".join(f"{d} {len(window.get(d, []))}" for d in cams))
    decoded = {d: first["beats"][d].get("decoded", 0) - first["beats0"][d].get("decoded", 0)
               for d in cams}
    log("phase 14 frames decoded per second by each worker over the window (heartbeats): "
        + ", ".join(f"{d} {decoded[d] / wall_s:.2f}" for d in cams))
    vit = [r for _, r in got.get("vit00", [])]
    vit_boxless = all(len(r.detections) == 5 and r.detections[0].box.width == 0
                      and r.detections[0].box.height == 0 for r in vit)
    t_vit = min((t for t, _ in got.get("vit00", [])), default=None)
    t_det = min((t for d in default for t, _ in got.get(d, [])), default=None)
    log(f"phase 14 vit00: {len(vit)} results, models {sorted({r.model for r in vit})}, 5 "
        f"box-less detections each {vit_boxless}; its first result "
        f"{(t_vit - t_det) if t_vit and t_det else float('nan'):.3f} s after the first "
        f"yolov8n result (its program captured on its first batch, no prewarm)")
    log(f"phase 14 graphs: {len(keys1)} step keys, of the models {sorted(set(keys1))}; "
        f"{graphs1}")
    dets = [d for cam in default for r in window.get(cam, []) for d in r.detections]
    untracked = sum(1 for d in dets if not d.track_id)
    engine_frames = p1.frames - p0.frames
    log(f"phase 14 engine over the window: {p1.batches - p0.batches} batches, shed "
        f"{p1.shed_frames - p0.shed_frames}, the drain's emit "
        f"{(p1.emit_ms - p0.emit_ms) / max(engine_frames, 1):.4f} ms a frame (tracker "
        f"{(p1.track_ms - p0.track_ms) / max(engine_frames, 1):.4f}); ladder "
        f"{first['health']['ladder']}, health ok {first['health']['ok']}; kernel launches "
        f"{first['launches']}")
    worker_cores = sum(first["cpu"].values()) / wall_s
    log(f"phase 14 host CPU ({os.cpu_count()} cores): the 16 workers {worker_cores:.3f} cores "
        f"in all, the server's process {first['cpu_server'] / wall_s:.3f} (its engine's "
        f"threads: {first['threads']}); worker limits {first['limits']}; workers with "
        f"libcuda mapped {first['cuda_workers']}; a {WAKE_SLEEP_S * 1000:g} ms sleep wakes "
        f"late by: {first['wake']}")
    events: dict = {}
    signed_ok = True
    for path, body, ok in sink.posts[:posts_first]:
        signed_ok = signed_ok and ok
        for e in body:
            events.setdefault((e["device_name"], e["type"]), []).append(e)
    per_stream = {d: sum(len(v) for (dn, _), v in events.items() if dn == d) for d in cams}
    kf_events = [e for (dn, _), v in events.items() if dn == kf_cam for e in v]
    offered = first["offered"]
    log("phase 14 annotation events offered to the uplink by device (accepted/shed at the "
        "queue's limit): " + ", ".join(f"{d} {offered.get(d, [0, 0])[0]}/"
                                     f"{offered.get(d, [0, 0])[1]}" for d in cams)
        + f"; cameras whose events were all shed, none at the sink: "
          f"{[d for d in default if not per_stream[d]]}")
    log(f"phase 14 annotation events at the sink: {posts_first} signed POSTs (every signature "
        f"verifies: {signed_ok}); per stream and type "
        f"{ {f'{d}/{t}': len(v) for (d, t), v in sorted(events.items())} }; the keyframe "
        f"stream's {len(kf_events)} events all from keyframes "
        f"{all(e['is_keyframe'] for e in kf_events)}; queue {ann_counts} (unacked limit "
        f"{cfg.annotation.unacked_limit}, the shed count is 'dropped'); spool {spool}")
    watch_us = first["watch_window_us"]
    by_action: dict = {}
    for ev in first["journal_window"]:
        key = f"{ev['actor']}.{ev['action']}"
        by_action[key] = by_action.get(key, 0) + 1
    log(f"phase 14 audit planes over the first window on {card}: _watch_tick "
        f"{len(watch_us)} ticks, mean {sum(watch_us) / max(len(watch_us), 1):.3f} us, p99 "
        f"{pct(watch_us, 99):.3f} us (timed from the script); journal "
        f"{len(first['journal_window'])} events, {len(first['journal_window']) / wall_s:.3f} "
        f"a second: {by_action}")
    log(f"phase 14 restart: SIGKILL {kill['victim']} (pid {kill['pid']}): respawned as pid "
        f"{kill['new_pid']} after {kill['respawn_s']:.3f} s, failing_streak {kill['streak']}, "
        f"oom_killed {kill['oom']}; its results back {kill['results_s']} s after the kill")
    # -- the re-adopting restart --------------------------------------------------------------
    now = second["runtime"]
    adopted = [d for d in cams if recorded.get(d) and (now.get(d) or {}).get("pid") == recorded[d]
               and (now.get(d) or {}).get("starttime") == starts[d]]
    respawned = [d for d in cams if d not in adopted]
    got2 = second["got"]
    first_after = {d: min((t for t, _ in got2.get(d, [])), default=None) for d in default}
    all_back = (max(first_after.values()) - second["t_boot"]
                if all(first_after.values()) else None)
    log(f"phase 14 re-adoption: Server.stop() detached {len(alive)} live workers; a new "
        f"Server on the same data dir resumed {second['resumed']} cameras (its start "
        f"{second['start_s']:.3f} s): {len(adopted)} re-adopted with the same pid and "
        f"starttime, {len(respawned)} respawned {respawned}; every yolov8n camera served again "
        f"{all_back} s after the resume began; results in its {SERVER_AFTER_RESUME_S:g} s: "
        + ", ".join(f"{d} {len(got2.get(d, []))}" for d in cams))
    if wire:
        log(f"phase 14 the wire on the card (the second server's Server.start()): "
            f"{second['wire']}")
        audit = second["audit"]
        for c in audit["captures"]:
            log(f"phase 14 capture {c['via']} on {card}: {c}")
        log(f"phase 14 captures: the keep mask's kernel events per bundle "
            + ", ".join(f"{c['via']} {c.get('nms_events')} (batches stepped during the call "
                        f"{c['batches']}, keep-mask launches {c['nms_launches']})"
                        for c in audit["captures"] if c["status"] == 200)
            + f"; results/s inside each window against the same length before: "
            + ", ".join(f"{c['via']} {c['fps_in']:.2f}/{c['fps_before']:.2f}"
                        for c in audit["captures"] if c["status"] == 200)
            + f"; the concurrent pair answered {audit['pair_statuses']}; workers respawned "
              f"during the captures {audit['respawned_during']}")
        log(f"phase 14 journal: {audit['journal']}")
        log(f"phase 14 why ladder:engine ({audit['why']['links']} links, "
            f"{audit['why']['escalates']} escalate, rooted at an SLO episode_open "
            f"{audit['why']['roots_at_slo']}, rung {audit['why']['rung']}): "
            + " <- ".join(reversed(audit["why"]["text"])))
        log(f"phase 14 stage legs on {card} (spans 1 in {audit['trace']['sample_every']}, "
            f"{audit['trace']['events']} events; leg: lineages, p50 ms, p95 ms): "
            + ", ".join(f"{k} {n} {p50:.3f} {p95:.3f}" if n else f"{k} 0"
                        for k, (n, p50, p95) in audit["trace"]["legs"].items()))
    for d in respawned[:3]:
        log(f"phase 14 {d} not re-adopted; at the first server's stop its recorded worker read: "
            f"{why.get(d, 'no recorded pid')}")
    failures = {m: logged.count(m) for m in FAILURE_MESSAGES}
    # -- gates --------------------------------------------------------------------------------
    missing = [d for d in cams if d != "off00" and not window.get(d)]
    if missing:
        raise AssertionError(f"phase 14: cameras without results: {missing}")
    if got.get("off00") or got2.get("off00"):
        raise AssertionError("phase 14: the camera with inference off has results")
    if not vit or {r.model for r in vit} != {SERVER_EXTRA_MODEL} or not vit_boxless:
        raise AssertionError(f"phase 14: vit00's results are not {SERVER_EXTRA_MODEL} top-5: "
                             f"{vit[:1]}")
    if untracked or not dets:
        raise AssertionError(f"phase 14: {untracked} of {len(dets)} detections without a "
                             f"track id")
    quiet = [d for d in default if not sum(offered.get(d, (0, 0)))]
    if quiet or per_stream["off00"] or sum(offered.get("off00", (0, 0))):
        raise AssertionError(f"phase 14: no annotation events offered to the uplink from "
                             f"{quiet}, or events from off00")
    if sum(per_stream.values()) != ann_counts["acked"]:
        raise AssertionError(f"phase 14: the sink got {sum(per_stream.values())} events, the "
                             f"queue acked {ann_counts['acked']}")
    if not signed_ok or not all(e["is_keyframe"] for e in kf_events):
        raise AssertionError("phase 14: an unsigned POST, or a non-keyframe event from the "
                             "keyframe stream")
    if not (kill["running"] and kill["new_pid"] != kill["pid"] and kill["streak"] == 1
            and kill["oom"] and kill["results_s"] is not None):
        raise AssertionError(f"phase 14: the killed worker did not come back: {kill}")
    if all_back is None:
        raise AssertionError(f"phase 14: after the resume, cameras without results: "
                             f"{[d for d, t in first_after.items() if t is None]}")
    if first["cuda_workers"]:
        raise AssertionError(f"phase 14: workers on the card: {first['cuda_workers']}")
    if wire and not second["wire"]["ok"]:
        raise AssertionError(f"phase 14: the wire check failed: {second['wire']}")
    if not wire:
        raise AssertionError("phase 14: the audit routes need the wire's packages")
    if second["audit"]["problems"]:
        raise AssertionError(f"phase 14: the audit planes: {second['audit']['problems']}")
    if any(failures.values()):
        raise AssertionError(f"phase 14: the engine logged failures: {logged.summary()}")
    for name, meta in kernels.items():
        if meta["path"] == "detect":
            if first["launches"][name] <= 0:
                raise AssertionError(f"kernel {name} was not launched in phase 14")
            report[name]["launches_server"] = first["launches"][name]


# -- phase 15: the detection step's variants and the device accounting ----------------------

# (stem, quantize, leg name of the accuracy gate)
VARIANTS = (("classic", "", "classic"), ("s2d", "", "s2d"), ("classic", "int8", "int8"),
            ("s2d", "int8", "s2d_int8"), ("classic", "int8_act", "int8_act"))
# The JAX package's gates, copied as they are: tools/stem_smoke.py:44-45
# (the fold in float32, the fused letterbox against the two-pass plane)
# and tools/bench_levers.py:254 (mAP50 against the classic fp detections).
FOLD_BOX_TOL_PX = 1e-3
FUSED_TOL = 2.0 / 255.0
ACCURACY_TOL = {"s2d": 0.95, "s2d_int8": 0.80, "int8": 0.80, "int8_act": 0.60}
# FUSED_TOL holds as it is on the frames it was measured on (stem_smoke.py:
# 2 of default_rng(5) at 270x480 -> 64). On the phase's 16 1080p frames the
# JAX package's own planes differ by REFERENCE_FUSED_DIFF (3 bf16 steps
# below 1; the port's planes equal JAX's bit for bit on the CPU:
# tools/torch_accuracy_gate.py, "fused_letterbox"); the bar there is the
# larger of the two.
FUSED_SMOKE_HW = (270, 480)
FUSED_SMOKE_DST = 64
REFERENCE_FUSED_DIFF = 0.01171875
FUSED_BAR = max(FUSED_TOL, REFERENCE_FUSED_DIFF)
# The phase's 16 1080p frames are the accuracy gate's: numpy default_rng(7)
# uint8 noise, as tools/bench_levers.py accuracy_gate makes them. On random
# weights and 1080p noise the top 100 anchors are near-ties, and the JAX
# package itself reads below ACCURACY_TOL at this geometry: on these
# weights (yolov8n, init_params seed 0, the class prior zeroed) and frames,
# bf16 on the CPU, by its engine's variant definitions, it reads
# REFERENCE_MAP50 (JAX_PLATFORMS=cpu python tools/torch_accuracy_gate.py
# --hw 1080x1920 --frames 16 --seeds 0 --port-weights). A leg is gated at
# ACCURACY_TOL, or where the reference falls short of it, at the
# reference's own score less REFERENCE_MARGIN: about twice the port's
# largest shortfall against the reference on the same weights and frames
# on the CPU (0.049 over six weight draws at 4 and 16 frames; PERF.md).
REFERENCE_MAP50 = {"s2d": 0.9315, "s2d_int8": 0.686, "int8": 0.7358, "int8_act": 0.4928}
REFERENCE_MARGIN = 0.1
ACCURACY_BAR = {leg: min(tol, REFERENCE_MAP50[leg] - REFERENCE_MARGIN)
                for leg, tol in ACCURACY_TOL.items()}
# ACCURACY_TOL holds as it is on the frames its values were measured on
# (4 of default_rng(7) at 270x480, LEVERS_r12_cpu.json).
ACCURACY_HW = (270, 480)
ACCURACY_FRAMES = 4
VARIANT_TICKS = 2            # 15: batches of 16 served through the pipeline per variant
INT8_LAYERS = ("down2", "c2f_2.cv1")   # 15: int8 convs held against the CPU


def hbm_route(engine) -> tuple:
    """(status, body) of GET /api/v1/hbm from the port's REST app over
    ``engine``, on a local test server."""
    import asyncio

    from aiohttp.test_utils import TestClient, TestServer

    from video_edge_ai_proxy_tpu_torch.serve.rest_api import build_app

    async def go():
        async with TestClient(TestServer(build_app(None, None, engine=engine))) as client:
            resp = await client.get("/api/v1/hbm")
            return resp.status, await resp.json()
    return asyncio.run(go())


def host_detections(out: dict) -> list:
    """A detection step's valid (boxes, scores, classes) per frame, on the
    host."""
    valid = out["valid"]
    return [(out["boxes"][i][valid[i]].float().cpu().numpy(),
             out["scores"][i][valid[i]].float().cpu().numpy(),
             out["classes"][i][valid[i]].cpu().numpy()) for i in range(valid.shape[0])]


def int8_conv_check(engine, frames, thumbs) -> list:
    """The int8 activation engine's convs ``INT8_LAYERS`` on the card against
    their plain CPU version: the quantized operands of one eager call
    (2 frames), each int32 product computed on the card and on the CPU.
    Returns [(layer, rows, reduction, width)]; raises on any difference."""
    import torch

    from video_edge_ai_proxy_tpu_torch.engine.runner import build_serving_step
    from video_edge_ai_proxy_tpu_torch.models.common import int8_conv2d

    inner = engine._model.model          # the QuantizedModel's network
    seen = {}
    hooks = []
    for name in INT8_LAYERS:
        conv = inner.get_submodule(name).conv

        def grab(mod, args, name=name):
            xq, wq, _, _ = mod.quantized(args[0])
            seen[name] = (xq, wq, mod.stride[0], mod.pad)
        hooks.append(conv.register_forward_pre_hook(grab))
    try:
        with torch.inference_mode():
            build_serving_step(engine._model, engine._spec, quality_thumb=THUMB)(
                frames[:2], thumbs[:2])
    finally:
        for h in hooks:
            h.remove()
    out = []
    for name in INT8_LAYERS:
        xq, wq, stride, pad = seen[name]
        card_y = int8_conv2d(xq, wq, stride, pad)
        cpu_y = int8_conv2d(xq.cpu(), wq.cpu(), stride, pad)
        if card_y.dtype != torch.int32 or not torch.equal(card_y.cpu(), cpu_y):
            raise AssertionError(f"phase 15: the int8 conv {name} on the card differs from its "
                                 f"plain CPU version")
        b, co, ho, wo = card_y.shape
        out.append((name, b * ho * wo, wq[0].numel(), co))
    return out


def variants_phase(dev, card: str, zero_launches, read_launches, kernels, report) -> None:
    """Phase 15: the detect family's variants (classic, s2d, int8, s2d with
    int8, int8_act) through the port's engine at 16x1080p, and the device
    accounting around each step (FLOPs, MFU against the resolved peak, the
    int8 residency, the program footprint, the HBM ledger)."""
    import copy
    import dataclasses

    import numpy as np
    import torch

    from video_edge_ai_proxy_tpu_torch.bus.interface import FrameMeta
    from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
    from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine, build_serving_step
    from video_edge_ai_proxy_tpu_torch.models import registry
    from video_edge_ai_proxy_tpu_torch.models.carry import fit_state
    from video_edge_ai_proxy_tpu_torch.models.metrics import DetectionEvaluator
    from video_edge_ai_proxy_tpu_torch.models.quantize import serving_state, tree_nbytes
    from video_edge_ai_proxy_tpu_torch.models.registry import place
    from video_edge_ai_proxy_tpu_torch.models.yolov8 import YOLOv8
    from video_edge_ai_proxy_tpu_torch.obs.perf import PEAK_TFLOPS_BF16, mfu_pct
    from video_edge_ai_proxy_tpu_torch.ops.preprocess import (
        preprocess_letterbox, preprocess_letterbox_fused, space_to_depth,
    )
    from video_edge_ai_proxy_tpu_torch.replay.checksum import zero_class_prior
    from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig

    log(f"phase 15 card: {card}")
    spec = registry.get("yolov8n")
    gen = torch.Generator(device=dev).manual_seed(15)
    host_frames = np.random.default_rng(7).integers(0, 256, (N_STREAMS,) + FRAME_HW + (3,),
                                                     dtype=np.uint8)
    frames = torch.from_numpy(host_frames).to(dev)
    thumbs = torch.rand((N_STREAMS, THUMB, THUMB), generator=gen, device=dev)

    # (a) the fused letterbox against space_to_depth of the two-pass plane,
    # on tools/stem_smoke.py's own frames and on the 16 1080p frames.
    def fused_diff(x, dst):
        with torch.inference_mode():
            fused, _ = preprocess_letterbox_fused(x, dst)
            two_pass, _ = preprocess_letterbox(x, dst)
            return float((fused.float() - space_to_depth(two_pass).float()).abs().max())

    smoke_diff = fused_diff(torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (2,) + FUSED_SMOKE_HW + (3,), dtype=np.uint8)).to(dev), FUSED_SMOKE_DST)
    wide_diff = fused_diff(frames, spec.input_size)
    log(f"phase 15a fused letterbox (bf16) against space_to_depth(preprocess_letterbox): "
        f"max |diff| {smoke_diff:.6f} on 2 frames of {FUSED_SMOKE_HW[1]}x{FUSED_SMOKE_HW[0]} "
        f"-> {FUSED_SMOKE_DST} (tolerance {FUSED_TOL:.6f}); {wide_diff:.6f} on the 16 1080p "
        f"frames -> 640 (bar {FUSED_BAR:.6f}; the JAX package {REFERENCE_FUSED_DIFF:.6f})")
    if smoke_diff > FUSED_TOL or wide_diff > FUSED_BAR:
        raise AssertionError(f"phase 15a: the fused letterbox differs by {smoke_diff} "
                             f"(stem_smoke's frames), {wide_diff} (1080p)")

    # (b) the fold in float32 eager: the classic model and its folded s2d
    # twin on the same letterboxed plane.
    f32 = spec.init_params(torch.Generator().manual_seed(0), device=dev, dtype=torch.float32)
    f32.load_state_dict(zero_class_prior(f32.state_dict()))
    s2d32 = YOLOv8(dataclasses.replace(f32.cfg, stem="s2d"), torch.float32)
    s2d32.load_state_dict(fit_state(f32.state_dict(), s2d32), strict=True)
    s2d32 = place(s2d32, dev, channels_last=True)
    with torch.inference_mode():
        plane = preprocess_letterbox(frames[:4], spec.input_size,
                                     out_dtype=torch.float32)[0].permute(0, 3, 1, 2)
        cb, cl, cc = f32(plane, decode="serving")
        sb, sl, sc = s2d32(plane, decode="serving")
        fold_diff = max(float((cb - sb).abs().max()), float((cl - sl).abs().max()))
        classes_equal = bool(torch.equal(cc, sc))
    del f32, s2d32, plane
    log(f"phase 15b the s2d fold in float32 (4 frames, {cb.shape[1]} anchors): boxes and logits "
        f"max |diff| {fold_diff:.3g} px (tolerance {FOLD_BOX_TOL_PX}), classes equal "
        f"{classes_equal}")
    if fold_diff > FOLD_BOX_TOL_PX or not classes_equal:
        raise AssertionError(f"phase 15b: the fold is not lossless ({fold_diff}, classes "
                             f"equal {classes_equal})")

    # (c) every variant through the engine.
    base = spec.init_params(torch.Generator().manual_seed(0), device=dev)
    base.load_state_dict(zero_class_prior(base.state_dict()))
    ticks = [[(f"cam{i:02d}", host_frames[i],
               FrameMeta(width=FRAME_HW[1], height=FRAME_HW[0], packet=t, timestamp_ms=1))
              for i in range(N_STREAMS)] for t in range(VARIANT_TICKS)]
    gate_frames = torch.from_numpy(np.random.default_rng(7).integers(
        0, 256, (ACCURACY_FRAMES,) + ACCURACY_HW + (3,), dtype=np.uint8)).to(dev)
    detections = {}
    gate_detections = {}
    launches_by_leg = {}
    rows = []
    for stem, quantize, leg in VARIANTS:
        engine = InferenceEngine(MemoryFrameBus(),
                                 EngineConfig(stem=stem, quantize=quantize, hbm=True),
                                 device=dev, model=copy.deepcopy(base))
        engine.warmup()
        if engine.perf.peak_tflops != PEAK_TFLOPS_BF16.get(torch.cuda.get_device_name(dev)):
            raise AssertionError(f"phase 15: peak {engine.perf.peak_tflops} TFLOP/s is not the "
                                 f"card's")
        t0 = time.perf_counter()
        engine.compile_for(FRAME_HW, N_STREAMS)
        build_s = time.perf_counter() - t0
        step = engine._step(FRAME_HW, N_STREAMS)
        eager = build_serving_step(engine._model, engine._spec, quality_thumb=THUMB)
        with engine._compute_stream(), torch.inference_mode():
            got = step(frames, thumbs)
            want = eager(frames, thumbs)
            torch.cuda.synchronize()
            for k in want:
                if got[k].dtype != want[k].dtype or not torch.equal(got[k], want[k]):
                    raise AssertionError(f"phase 15 {leg}: the replay's {k} differs from the "
                                         f"eager step")
            replay_wall, replay_ms = median_call_ms(lambda: step(frames, thumbs))
            eager_wall, eager_ms = median_call_ms(lambda: eager(frames, thumbs))
        detections[leg] = host_detections(got)
        with engine._compute_stream(), torch.inference_mode():
            gate_detections[leg] = host_detections(
                engine._step(ACCURACY_HW, ACCURACY_FRAMES)(gate_frames))
        int8_layers = (int8_conv_check(engine, frames, thumbs) if quantize == "int8_act"
                       else [])
        del got, want, eager

        zero_launches()
        engine.serve_lockstep(ticks)
        launches = read_launches()
        want_launches = {n: (VARIANT_TICKS if kernels[n]["path"] == "detect" else 0)
                         for n in kernels}
        if launches != want_launches:
            raise AssertionError(f"phase 15 {leg}: launches {launches}, expected "
                                 f"{want_launches}")
        launches_by_leg[leg] = launches["nms_keep_mask"]

        snap = engine.perf.snapshot()
        geometry = f"{FRAME_HW[0]}x{FRAME_HW[1]}"
        [rec] = [r for r in snap["compiles"] if (r["geometry"], r["bucket"]) == (geometry,
                                                                                 N_STREAMS)]
        [cell] = snap["buckets"]
        flops = rec["flops"]
        peak = snap["peak_tflops"]
        mfu = mfu_pct(flops, replay_ms, peak)
        fp_bytes, q_bytes = engine.residency.get(
            spec.name, (tree_nbytes(serving_state(engine._model)),) * 2)
        prog = engine.hbm.programs()[f"{spec.name}|{stem}|{geometry}|{N_STREAMS}|-"]
        pools = engine.hbm.pools()
        own = {"thumbs": int(engine._thumbs.nbytes()), "track_state": 0,
               "prefetch": int(engine._xfer.nbytes()),
               "collector_host": int(engine._collector.pool_nbytes())}
        tracked = {k: r["bytes"] for k, r in pools["pools"].items()}
        total = torch.cuda.mem_get_info(dev)[1]
        status, body = hbm_route(engine)
        graph_pool = engine.graph_stats()["pool_bytes"]
        if tracked != own or pools["total"] != sum(own.values()):
            raise AssertionError(f"phase 15 {leg}: tracked pools {tracked} != their own {own}")
        if engine.hbm.budget_bytes != total or not engine.hbm.budget_measured:
            raise AssertionError(f"phase 15 {leg}: budget {engine.hbm.budget_bytes} is not the "
                                 f"card's {total}")
        if status != 200 or body["programs"] != engine.hbm.programs():
            raise AssertionError(f"phase 15 {leg}: /api/v1/hbm answered {status}")
        if flops <= 0 or mfu is None or cell["frames"] != VARIANT_TICKS * N_STREAMS:
            raise AssertionError(f"phase 15 {leg}: flops {flops}, mfu {mfu}, served {cell}")
        log(f"phase 15 {leg} (stem={stem}, quantize={quantize or 'none'}) on {card}: replay "
            f"{replay_ms:.3f} ms a 16-frame step (median of 20, CUDA events; {replay_wall:.3f} "
            f"ms wall), eager {eager_ms:.3f} ms; program built in {build_s:.2f} s; "
            f"{flops / 1e9:.3f} GFLOP a program (FlopCounterMode), MFU {mfu:.3f}% of {peak} "
            f"TFLOP/s at the replay's time, live gauge {cell['mfu_pct']}% at the served "
            f"batches' {cell['device_ms_ema']} ms; weights {q_bytes / 2 ** 20:.3f} MiB against "
            f"{fp_bytes / 2 ** 20:.3f} MiB fp ({q_bytes / fp_bytes:.3f}); footprint "
            f"{prog['workspace_bytes'] / 2 ** 20:.1f} MiB (inputs {prog['argument_bytes']} B, "
            f"outputs {prog['output_bytes']} B, pool growth {prog['temp_bytes'] / 2 ** 20:.1f} "
            f"MiB), graph pool {graph_pool / 2 ** 20:.1f} MiB; HBM ledger pools {tracked} = "
            f"their own bytes, budget {total} B (the card's total), /api/v1/hbm {status}; keep "
            f"mask {launches['nms_keep_mask']} launches over {VARIANT_TICKS} served batches"
            + "".join(f"; int8 conv {n} [{m}x{k}]x[{k}x{w}] int32 equal to the CPU's"
                      for n, m, k, w in int8_layers))
        rows.append((leg, replay_ms, flops, mfu))
        del engine, step
        torch.cuda.empty_cache()

    # (d) accuracy in bf16: each variant's detections against the classic
    # fp step's as ground truth, on the 16 1080p frames served above and
    # on the tolerances' own 270x480 frames.
    def map50(dets):
        out = {}
        for leg in ACCURACY_TOL:
            ev = DetectionEvaluator()
            for (gb, _, gc), (pb, ps, pc) in zip(dets["classic"], dets[leg]):
                ev.add_image(pb, ps, pc, gb, gc)
            out[leg] = ev.summarize()["mAP50"]
        return out, sum(len(b) for b, _, _ in dets["classic"])

    wide, n_wide = map50(detections)
    scores, n_gt = map50(gate_detections)
    log(f"phase 15d mAP50 against the classic fp detections on the 16 1080p frames "
        f"({n_wide}): " + ", ".join(
            f"{leg} {m:.4f} (bar {ACCURACY_BAR[leg]:.4f}; the JAX package "
            f"{REFERENCE_MAP50[leg]}, tolerance {ACCURACY_TOL[leg]})" for leg, m in wide.items())
        + f"; on {ACCURACY_FRAMES} frames of {ACCURACY_HW[1]}x{ACCURACY_HW[0]} ({n_gt}): "
        + ", ".join(f"{leg} {m:.4f} (tolerance {ACCURACY_TOL[leg]})"
                    for leg, m in scores.items()))
    failed = ([leg for leg, m in wide.items() if not m >= ACCURACY_BAR[leg]]
              + [f"{leg}@{ACCURACY_HW[0]}p" for leg, m in scores.items()
                 if not m >= ACCURACY_TOL[leg]])
    if n_wide == 0 or n_gt == 0 or failed:
        raise AssertionError(f"phase 15d: accuracy below the bar for {failed} (1080p {wide}, "
                             f"{ACCURACY_HW[0]}p {scores}), {n_wide} and {n_gt} ground-truth "
                             f"detections")
    classic_ms = rows[0][1]
    log("phase 15 replay against classic in this call: " + ", ".join(
        f"{leg} {ms / classic_ms:.3f}x" for leg, ms, _, _ in rows))
    report["nms_keep_mask"]["launches_variants"] = launches_by_leg



# -- phases 16 and 17: ROI serving and the temporal cascade -------------------------------

# 16a: tools/roi_smoke.py's scenario at 1080p on blob_gauge: 8 streams with a
# blob in slow motion (a triangle wave along x), one color key each (the
# gauge has 8, and reports one box per key and canvas), and 8 static
# scenes (a dark block the gauge does not see). Each stream's block stays
# in a cell of its own of a 4x4 grid, so a detection routed to the wrong
# stream has no overlap with that stream's blob. Corners and sizes are
# multiples of 3, the 1080p -> 640 letterbox's grid. A mover's background
# has its key's red and a dark green: the letterbox's antialiased resize
# of a full frame mixes the blob's edge with the background, and on a 114
# gray one keys 0 and 7 mix into a neighbouring bin (a second box); with
# the red shared only green moves, which the gauge's bins do not read.
ROI_TICKS = 40               # hand-stepped ticks a run, paced to 30 a second
ROI_TICK_S = 1.0 / 30.0
ROI_BLOB = (180, 135)        # blob w, h in source px
ROI_SPEED = 48               # a mover's px a tick: its 32^2 thumbnail diff
                             # (1.4e-4) clears roi_idle_diff 5e-5
ROI_FULL_MS = 500            # roi_full_interval_ms, roi_smoke.py's
ROI_MIN_IOU = 0.9            # roi_smoke.py's gates
ROI_MIN_GAIN = 2.0
ROI_MIN_MATCHED = 20
ROI_STATIC_COLOR = (40, 60, 40)   # BGR: green far below the gauge's 0.75
ROI_MOVER_BG_GREEN = 40           # a mover's background (114, 40, its key's red)
ROI_DET_TICKS = 12           # 16b: hand-stepped ticks of yolov8n a run
# Phase 11's folds (lockstep_checksum, serve_lockstep) at 16x1080p: the
# classic path with roi and cascade off folds to these on the H100.
ROI_OFF_FOLDS = (305268384, 304869744)
ROI_DET_MODEL = "yolov8n"    # 16b's detector
# 17: tools/cascade_smoke.py's scene at 1080p (its 64-px boxes scaled up).
CASCADE_N = 4
CASCADE_MODEL = "videomae_b"             # 17a's head (224^2, clip 8)
CASCADE_LONG_MODEL = "videomae_b_long"   # 17b's head (64 frames, 6272 tokens)
CASCADE_BOXES = {"camA": (1, (480, 300, 720, 480)), "camB": (2, (120, 660, 360, 840)),
                 "camC": (4, (1320, 120, 1560, 300))}
CASCADE_CHURN_BOX = (1320, 660, 1560, 840)
CASCADE_LONG_STREAMS = 2     # 17b
CASCADE_HARVEST_TICKS = 4    # 17c: yolov8n ticks with the cascade's harvest on


def roi_truth(stream: int, step: int) -> tuple:
    """16a's (box, key) of ``stream`` at ``step``, inside the stream's cell
    of a 4x4 grid: streams 0-7 are blobs of key ``stream`` moving along x,
    8-15 a static block of no key (None)."""
    w, h = ROI_BLOB
    cw, ch = FRAME_HW[1] // 4, FRAME_HW[0] // 4
    cx, cy = cw * (stream % 4), ch * (stream // 4)
    y0 = cy + 66
    if stream < 8:
        span = cw - w - 48
        phase = (step * ROI_SPEED) % (2 * span)
        x0 = cx + 24 + (phase if phase < span else 2 * span - phase)
    else:
        x0 = cx + 150
    return (x0, y0, x0 + w, y0 + h), (stream if stream < 8 else None)


def box_iou(a, b) -> float:
    ix0, iy0 = max(a[0], b[0]), max(a[1], b[1])
    ix1, iy1 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0, ix1 - ix0) * max(0, iy1 - iy0)
    area = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / float(area) if inter else 0.0


class TickClock:
    """16a's engine clock: ``monotonic`` advances ``ROI_TICK_S`` a tick, the
    scene's cadence, whatever a hand-stepped tick takes on the host. The ROI
    gate refreshes a stream's full frame every ``roi_full_interval_ms`` of
    this clock and reads motion from the difference of two full frames; on
    the host's clock the refresh fell every 6-9 ticks, in step with the
    movers' 10.5-tick bounce, and the gate saw a mover at rest and coasted
    it (misrouted detections in some runs on the card; the same scene with
    the clock stepped 60 or 75-95 ms a tick misroutes on the CPU, 33.3 ms
    does not). While entered it stands in
    for the engine module's ``time``; the rest of ``time`` is the real one."""

    def __init__(self):
        self.now = time.monotonic()

    def __enter__(self):
        import types

        from video_edge_ai_proxy_tpu_torch.engine import runner

        self._runner, self._real = runner, runner.time
        clock = types.SimpleNamespace(
            **{n: getattr(time, n) for n in dir(time) if not n.startswith("_")})
        clock.monotonic = lambda: self.now
        runner.time = clock
        return self

    def __exit__(self, *exc):
        self._runner.time = self._real

    def tick(self) -> None:
        self.now += ROI_TICK_S


def hand_engine(engine):
    """Make ``engine`` hand-steppable, as the JAX package's ROI and cascade
    tests drive theirs: warm, a drain queue deep enough for the full,
    canvas and coast groups of one tick, and one subscriber over every
    stream. Returns the subscriber's queue."""
    import queue

    engine.warmup()
    engine._drain_q = queue.Queue(maxsize=8)
    q = queue.Queue()
    with engine._sub_lock:
        engine._subscribers.append((q, None))
    return q


def hand_tick(engine, results_q, on_group=None) -> list:
    """One engine tick by hand on the engine's compute stream: collect,
    the ROI transform, dispatch, drain and emit (the cascade's harvest),
    the cascade tick. ``on_group(group)`` sees each group before dispatch.
    Returns the results the tick published."""
    import queue

    import torch

    with engine._compute_stream(), torch.inference_mode():
        groups = engine._collector.collect()
        if engine._roi is not None and groups:
            groups = engine._roi_transform(groups)
        if on_group is not None:
            for g in groups:
                on_group(g)
        engine._dispatch(groups, time.time(), strict=True)
        while True:
            try:
                inflight = engine._drain_q.get_nowait()
            except queue.Empty:
                break
            try:
                engine._emit(inflight)
            finally:
                engine._collector.release(inflight.group)
                engine._drain_q.task_done()
        if engine._cascade is not None:
            engine._cascade_tick()
    out = []
    while not results_q.empty():
        out.append(results_q.get_nowait())
    return out


def roi_phase(dev, card: str, zero_launches, read_launches, kernels, report,
              pipeline: dict) -> None:
    """Phase 16: ROI serving at full width. (a) tools/roi_smoke.py's gauge
    run at 16x1080p, roi off then on; (b) yolov8n bf16 at 16x1080p with
    roi on: the canvas program's replay against eager, the keep mask in
    it by the profiler, the canvas and full steps' replay times, the
    emit's cost a frame with roi on and off; phase 11's folds with roi
    off."""
    import numpy as np
    import torch

    from video_edge_ai_proxy_tpu_torch.bus.interface import FrameMeta
    from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
    from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine, build_serving_step
    from video_edge_ai_proxy_tpu_torch.ingest.sources import SyntheticSource
    from video_edge_ai_proxy_tpu_torch.models import registry
    from video_edge_ai_proxy_tpu_torch.models.blob import blob_color
    from video_edge_ai_proxy_tpu_torch.replay.checksum import zero_class_prior
    from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig

    log(f"phase 16 card: {card}")
    h, w = FRAME_HW

    # (a) the gauge run, roi off and on.
    def gauge_run(roi: bool) -> dict:
        bus = MemoryFrameBus()
        engine = InferenceEngine(bus, EngineConfig(
            model="blob_gauge", tick_ms=10, prefetch=False, prof=False, roi=roi,
            roi_min_crop=80, roi_full_interval_ms=ROI_FULL_MS), device=dev)
        results_q = hand_engine(engine)
        frames = []
        backgrounds = []
        for s in range(N_STREAMS):
            bus.create_stream(f"cam{s:02d}", h * w * 3)
            _, key = roi_truth(s, 0)
            bg = (114, 114, 114) if key is None else (114, ROI_MOVER_BG_GREEN, blob_color(key)[2])
            backgrounds.append(bg)
            frames.append(np.empty((h, w, 3), np.uint8))
            frames[-1][:] = bg
        truth: dict = {}
        results = []
        prev = [None] * N_STREAMS
        ts0 = int(time.time() * 1000)
        zero_launches()
        t0 = time.perf_counter()
        with TickClock() as clock:
            for step in range(ROI_TICKS):
                pace = t0 + step * ROI_TICK_S - time.perf_counter()
                if pace > 0:
                    time.sleep(pace)
                ts = ts0 + step
                for s in range(N_STREAMS):
                    box, key = roi_truth(s, step)
                    if prev[s] is not None and prev[s] != box:
                        x0, y0, x1, y1 = prev[s]
                        frames[s][y0:y1, x0:x1] = backgrounds[s]
                    x0, y0, x1, y1 = box
                    frames[s][y0:y1, x0:x1] = (ROI_STATIC_COLOR if key is None
                                               else blob_color(key))
                    prev[s] = box
                    truth[(f"cam{s:02d}", ts)] = (key, box)
                    bus.publish(f"cam{s:02d}", frames[s], FrameMeta(
                        width=w, height=h, channels=3, timestamp_ms=ts, is_keyframe=True))
                results.extend(hand_tick(engine, results_q))
                clock.tick()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = read_launches()
        snap = engine.perf.snapshot()
        ious, misrouted, matched, edge = [], 0, 0, 0
        for r in results:
            key, box = truth[(r.device_id, r.timestamp)]
            for d in r.detections:
                got = (d.box.left, d.box.top, d.box.left + d.box.width, d.box.top + d.box.height)
                iou = box_iou(got, box)
                if key is None or iou == 0.0:
                    # On a static scene, or off its stream's blob: another
                    # stream's detection.
                    misrouted += 1
                elif d.class_id != key:
                    # On the blob, another key: a full frame's resize mixed
                    # the edge into a neighbouring bin.
                    edge += 1
                else:
                    matched += 1
                    ious.append(iou)
        device_frames = sum(b["frames"] for b in snap["buckets"] if b["model"] == "blob_gauge")
        p = engine.pipeline_stats()
        bus.close()
        del engine
        return {"roi": roi, "results": len(results), "device_frames": device_frames,
                "per_device_frame": len(results) / device_frames if device_frames else None,
                "matched": matched, "misrouted": misrouted, "edge": edge,
                "iou_mean": float(np.mean(ious)) if ious else None,
                "iou_min": float(np.min(ious)) if ious else None,
                "perf_roi": snap.get("roi"), "launches": launches, "wall_s": wall_s,
                "emit_ms_frame": p.emit_ms / max(p.frames, 1)}

    base = gauge_run(False)
    packed = gauge_run(True)
    gain = (packed["per_device_frame"] / base["per_device_frame"]
            if packed["per_device_frame"] and base["per_device_frame"] else None)
    roi_stats = packed["perf_roi"] or {}
    ticks = roi_stats.get("stream_ticks", {})
    report["nms_keep_mask"]["launches_roi"] = packed["launches"]["nms_keep_mask"]
    for run in (base, packed):
        log(f"phase 16a blob_gauge {N_STREAMS}x1080p roi={run['roi']} on {card}: "
            f"{run['results']} results over {run['device_frames']} device frames "
            f"({run['per_device_frame']:.3f} a frame), {run['matched']} detections matched, "
            f"{run['misrouted']} misrouted, {run['edge']} edge bins, IoU mean "
            f"{run['iou_mean']} min {run['iou_min']}; "
            f"{ROI_TICKS} ticks in {run['wall_s']:.3f} s; emit {run['emit_ms_frame']:.4f} ms "
            f"a frame; keep-mask launches {run['launches']['nms_keep_mask']}")
    log(f"phase 16a ROI plane: {roi_stats}; results per device frame {gain:.3f}x the "
        f"roi=False run" if gain is not None else f"phase 16a ROI plane: {roi_stats}")
    if packed["matched"] < ROI_MIN_MATCHED:
        raise AssertionError(f"phase 16a: only {packed['matched']} matched detections")
    if packed["misrouted"] or base["misrouted"]:
        raise AssertionError(f"phase 16a: misrouted detections (roi {packed['misrouted']}, "
                             f"baseline {base['misrouted']})")
    if roi_stats.get("unrouted"):
        raise AssertionError(f"phase 16a: {roi_stats['unrouted']} unrouted canvas detections")
    if packed["iou_mean"] is None or packed["iou_mean"] < ROI_MIN_IOU:
        raise AssertionError(f"phase 16a: IoU mean {packed['iou_mean']} < {ROI_MIN_IOU}")
    if not (ticks.get("idle", 0) + ticks.get("roi", 0)) or not roi_stats.get("canvases"):
        raise AssertionError(f"phase 16a: the motion gate never engaged: {roi_stats}")
    if gain is None or gain < ROI_MIN_GAIN:
        raise AssertionError(f"phase 16a: results per device frame {gain} < {ROI_MIN_GAIN}x "
                             f"the roi=False run")
    if packed["launches"]["nms_keep_mask"] <= 0:
        raise AssertionError("phase 16a: the keep-mask kernel was not launched")

    # (b) yolov8n at 16x1080p, roi on, against roi off.
    if (pipeline["11a"], pipeline["11b"]) != ROI_OFF_FOLDS:
        raise AssertionError(f"phase 16b: with roi and cascade off phase 11 folded "
                             f"{pipeline['11a']}, {pipeline['11b']}, not {ROI_OFF_FOLDS}")
    log(f"phase 16b roi and cascade off: phase 11 folded {pipeline['11a']} and "
        f"{pipeline['11b']}, as before ({ROI_OFF_FOLDS})")
    spec = registry.get(ROI_DET_MODEL)
    model = spec.init_params(torch.Generator().manual_seed(0), device=dev)
    model.load_state_dict(zero_class_prior(model.state_dict()))
    pool = [SyntheticSource.render(h, w, n) for n in range(8)]
    streams = [f"cam{i:02d}" for i in range(N_STREAMS)]
    runs = {}
    canvas_batches: list = []
    for roi in (False, True):
        bus = MemoryFrameBus()
        engine = InferenceEngine(bus, EngineConfig(model=ROI_DET_MODEL, roi=roi, prof=False,
                                                   prefetch=False),
                                 device=dev, model=model)
        results_q = hand_engine(engine)
        for s in streams:
            bus.create_stream(s, h * w * 3)
        per_tick = []

        def keep_canvas(g):
            if g.crops is not None:
                canvas_batches.append((g.frames.copy(), len(g.device_ids), len(g.crops)))

        zero_launches()
        t0 = time.perf_counter()
        n_res = 0
        for step in range(ROI_DET_TICKS):
            ts = int(time.time() * 1000)
            for i, s in enumerate(streams):
                bus.publish(s, pool[(step + i) % len(pool)], FrameMeta(
                    width=w, height=h, channels=3, timestamp_ms=ts, is_keyframe=True))
            before = dict((engine.perf.snapshot().get("roi") or {}))
            n_res += len(hand_tick(engine, results_q, keep_canvas if roi else None))
            after = engine.perf.snapshot().get("roi") or {}
            per_tick.append((after.get("canvases", 0) - before.get("canvases", 0),
                             after.get("crops", 0) - before.get("crops", 0)))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        p = engine.pipeline_stats()
        runs[roi] = {"engine": engine, "bus": bus, "per_tick": per_tick, "results": n_res,
                     "launches": read_launches(), "wall_s": wall_s,
                     "emit_ms_frame": p.emit_ms / max(p.frames, 1),
                     "perf_roi": engine.perf.snapshot().get("roi")}
    on, off = runs[True], runs[False]
    log(f"phase 16b {ROI_DET_MODEL} bf16 {N_STREAMS}x1080p, {ROI_DET_TICKS} hand-stepped ticks on "
        f"{card}: roi off {off['results']} results in {off['wall_s']:.3f} s, roi on "
        f"{on['results']} in {on['wall_s']:.3f} s; canvases and crops a tick "
        f"{on['per_tick']}; ROI plane {on['perf_roi']}; the emit "
        f"{on['emit_ms_frame']:.4f} ms a frame with roi on, {off['emit_ms_frame']:.4f} off; "
        f"keep-mask launches on {on['launches']['nms_keep_mask']}, off "
        f"{off['launches']['nms_keep_mask']}")
    if on["results"] != off["results"] or on["launches"]["nms_keep_mask"] <= 0:
        raise AssertionError(f"phase 16b: roi on served {on['results']} results "
                             f"(off {off['results']}), keep-mask launches {on['launches']}")
    if not canvas_batches:
        raise AssertionError(f"phase 16b: no canvas batch was served: {on['perf_roi']}")
    engine = on["engine"]
    host_canvas, n_canvas, n_crops = canvas_batches[-1]
    canvas = torch.from_numpy(host_canvas).to(dev)
    bucket = canvas.shape[0]
    side = engine._cfg.roi_canvas
    eager = build_serving_step(engine._model, spec, quality_thumb=THUMB)
    with engine._compute_stream(), torch.inference_mode():
        graphed = engine._step((side, side), bucket)
        full = engine._step(FRAME_HW, N_STREAMS)
        got = graphed(canvas)
        want = eager(canvas)
        torch.cuda.synchronize()
        for k in ("boxes", "scores", "classes", "valid"):
            if not torch.equal(got[k], want[k]):
                raise AssertionError(f"phase 16b: the canvas program's replay differs from "
                                     f"its eager step in {k}")
        names = launched_kernels(lambda: graphed(canvas))
        keep = [n for n in names if "nms_keep_mask" in n]
        frames16 = torch.from_numpy(np.stack([pool[i % len(pool)] for i in range(N_STREAMS)])
                                    ).to(dev)
        canvas_ms = time_events(lambda: graphed(canvas), 20)
        full_ms = time_events(lambda: full(frames16), 20)
        canvas_ms2 = time_events(lambda: graphed(canvas), 20)
    if len(keep) != 1:
        raise AssertionError(f"phase 16b: the profiler found {keep} in one canvas replay "
                             f"({len(names)} kernels)")
    log(f"phase 16b canvas program ({ROI_DET_MODEL}, classic, {side}x{side}, bucket {bucket}: "
        f"{n_canvas} canvases of {n_crops} crops): replay bit-identical to eager; one replay "
        f"ran {len(names)} device kernels, the keep mask among them ({keep[0][:60]}); on "
        f"{card}: canvas replay {canvas_ms:.3f} then {canvas_ms2:.3f} ms against the "
        f"{N_STREAMS}x1080p full step's {full_ms:.3f} ms (CUDA events, mean of 20)")
    for run in runs.values():
        run["bus"].close()
    del runs, engine, on, off, model, canvas, frames16
    torch.cuda.empty_cache()


def cascade_phase(dev, card: str, zero_launches, read_launches, kernels, report) -> None:
    """Phase 17: the temporal cascade at full width. (a)
    tools/cascade_smoke.py's scene at 1080p on blob_gauge with videomae_b's
    head every 4 ticks and its five gates; (b) videomae_b_long's head
    (6272 tokens) through the flash forward, against the plain attention;
    (c) the harvest's host cost on yolov8n's detections at 16x1080p."""
    import tempfile

    import numpy as np
    import torch

    from video_edge_ai_proxy_tpu_torch.bus.interface import FrameMeta
    from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
    from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine, _build_cascade_head
    from video_edge_ai_proxy_tpu_torch.ingest.archive import SegmentArchiver
    from video_edge_ai_proxy_tpu_torch.models import registry
    from video_edge_ai_proxy_tpu_torch.proto.annotate import decode
    from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig

    log(f"phase 17 card: {card}")
    h, w = FRAME_HW

    class Sink:
        def __init__(self):
            self.items = []

        def publish(self, payload):
            self.items.append(payload)

    def blob_frame(delta, box, key):
        frame = np.full((h, w, 3), 114, np.uint8)
        x0, y0, x1, y1 = box
        frame[y0:y1, x0:x1] = (64 + delta, 255, key * 32 + 16)
        return frame

    def timed_head(engine, record):
        real = engine._cascade_head

        def head(pool, slot_idx, time_idx, n_real):
            out, ms = real(pool, slot_idx, time_idx, n_real)
            record.append(ms)
            return out, ms
        engine._cascade.head = head

    # (a) the scripted scene.
    n = CASCADE_N
    sink = Sink()
    tmp = tempfile.mkdtemp(prefix="vep_cascade_")
    archiver = SegmentArchiver(tmp)
    archiver.start()
    bus = MemoryFrameBus()
    engine = InferenceEngine(bus, EngineConfig(
        model="blob_gauge", tick_ms=10, prefetch=False, prof=False, track=True, cascade=True,
        cascade_model=CASCADE_MODEL, cascade_every_n=n, cascade_track_ttl_ticks=4, hbm=True),
        device=dev, annotations=sink, archiver=archiver)
    results_q = hand_engine(engine)
    sched = engine.cascade
    head_ms: list = []
    timed_head(engine, head_ms)
    clip_len = registry.get(CASCADE_MODEL).clip_len
    warmup, flicker, recover, churn = clip_len + 2 * n, 4 * n, 6 * n, 3 * (2 + 4 + 2)
    total = warmup + flicker + recover + churn
    onset = warmup + 1
    for name in list(CASCADE_BOXES) + ["camD"]:
        bus.create_stream(name, h * w * 3)
    statics = {name: blob_frame(0, box, key) for name, (key, box) in CASCADE_BOXES.items()}
    flick = {d: blob_frame(d, CASCADE_BOXES["camA"][1], CASCADE_BOXES["camA"][0])
             for d in (15, -15)}
    churn_frame = blob_frame(0, CASCADE_CHURN_BOX, 6)
    zero_launches()
    t0 = time.perf_counter()
    last_ts = 0
    for tick in range(1, total + 1):
        ts = max(int(time.time() * 1000), last_ts + 1)
        last_ts = ts
        meta = FrameMeta(width=w, height=h, channels=3, timestamp_ms=ts, is_keyframe=True)
        for name in CASCADE_BOXES:
            frame = statics[name]
            if name == "camA" and onset <= tick <= warmup + flicker:
                frame = flick[15 if tick % 2 == 0 else -15]
            bus.publish(name, frame, meta)
        if tick > warmup + flicker + recover:
            if (tick - warmup - flicker - recover - 1) % 8 < 2:   # camD: 2 of every 8
                bus.publish("camD", churn_frame, meta)
        hand_tick(engine, results_q)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    report["nms_keep_mask"]["launches_cascade"] = launches["nms_keep_mask"]
    snap = sched.snapshot()
    p = engine.pipeline_stats()
    hbm_status, hbm_body = hbm_route(engine)
    hbm_track = (hbm_body["pools"]["pools"].get("track_state", {}).get("bytes")
                 if hbm_status == 200 else hbm_status)
    pool_bytes = sched.pool_nbytes()
    deadline = time.monotonic() + 30
    reqs = [decode(x) for x in sink.items]
    casc = [r for r in reqs if r.type == "cascade"]
    enters = [r for r in casc if r.object_type == "anomaly_enter"]
    exits = [r for r in casc if r.object_type == "anomaly_exit"]
    while archiver.written < len(enters) and time.monotonic() < deadline:
        time.sleep(0.05)
    archiver.stop()
    written = archiver.written
    files = sorted(os.path.relpath(os.path.join(d, f), tmp) for d, _, fs in os.walk(tmp)
                   for f in fs)
    head_ticks = snap["head_ticks"]
    gaps = sorted({b - a for a, b in zip(head_ticks, head_ticks[1:])})
    enter_ticks = [e["tick"] for e in snap["events"] if e["kind"] == "enter"]
    latency = enter_ticks[0] - onset if enter_ticks else None
    peak_tracks = 4              # camA, camB, camC and one churn wave of camD
    events = [(e["stream"], e["kind"], e["tick"], round(e["score"], 4),
               [round(v, 6) for v in e["features"]]) for e in snap["events"]]
    log(f"phase 17a cascade on {card}: blob_gauge {len(CASCADE_BOXES) + 1} streams at 1080p, "
        f"{CASCADE_MODEL} head ({snap['side']}^2, clip {snap['clip_len']}) every {n} ticks; "
        f"{total} ticks in "
        f"{wall_s:.3f} s; head ticks {head_ticks[:4]}... gaps {gaps}; onset {onset}, enter at "
        f"{enter_ticks} (latency {latency} ticks); events {snap['event_counts']}; uplink "
        f"{len(enters)} enter, {len(exits)} exit from {sorted({r.device_name for r in casc})}; "
        f"archive {written} segment(s) {files}; slot high water {snap['slot_high_water']} "
        f"(peak tracks {peak_tracks}); harvested {snap['harvested']} tiles; keep-mask "
        f"launches {launches['nms_keep_mask']}; events (stream, kind, tick, score, features "
        f"[diff, var, top]) {events}")
    log(f"phase 17a on {card}: the head {statistics.median(head_ms):.3f} ms a dispatch "
        f"(median of {len(head_ms)}, max {max(head_ms):.3f}, the first with its capture; CUDA "
        f"events, the gather included), the pool {pool_bytes} B; /api/v1/hbm track_state {hbm_track} B; the "
        f"harvest {p.harvest_ms / max(p.frames, 1):.4f} ms a frame of the emit's "
        f"{p.emit_ms / max(p.frames, 1):.4f}")
    if not head_ticks or gaps != [n]:
        raise AssertionError(f"phase 17a: head cadence not exactly 1/{n}: {head_ticks}")
    if latency is None or latency > 2 * n:
        raise AssertionError(f"phase 17a: enter latency {latency} ticks > {2 * n}")
    if any(r.device_name != "camA" for r in casc):
        raise AssertionError(f"phase 17a: an event on a static track: "
                             f"{[(r.device_name, r.object_type) for r in casc]}")
    if snap["slot_high_water"] > peak_tracks:
        raise AssertionError(f"phase 17a: slot high water {snap['slot_high_water']} > "
                             f"{peak_tracks}")
    if len(enters) != 1 or len(exits) != 1 or written != 1:
        raise AssertionError(f"phase 17a: uplink enter {len(enters)}, exit {len(exits)}, "
                             f"archive {written}; expected exactly 1 each")
    if hbm_track != pool_bytes or not pool_bytes:
        raise AssertionError(f"phase 17a: /api/v1/hbm track_state {hbm_track} != the pool's "
                             f"{pool_bytes} B")
    if launches["nms_keep_mask"] <= 0:
        raise AssertionError("phase 17a: the keep-mask kernel was not launched")
    bus.close()
    del engine, sched
    torch.cuda.empty_cache()

    # (b) videomae_b_long's head: 64-frame clips, 6272 tokens, the flash
    # forward inside the head's program.
    bus = MemoryFrameBus()
    engine = InferenceEngine(bus, EngineConfig(
        model="blob_gauge", tick_ms=10, prefetch=False, prof=False, track=True, cascade=True,
        cascade_model=CASCADE_LONG_MODEL, cascade_every_n=n), device=dev, annotations=Sink())
    results_q = hand_engine(engine)
    sched = engine.cascade
    head_ms = []
    timed_head(engine, head_ms)
    names = list(CASCADE_BOXES)[:CASCADE_LONG_STREAMS]
    for name in names:
        bus.create_stream(name, h * w * 3)
    zero_launches()
    t0 = time.perf_counter()
    tick = 0
    while sched.head_dispatches < 1 and tick < 200:
        tick += 1
        ts = int(time.time() * 1000)
        for name in names:
            frame = flick[15 if tick % 2 == 0 else -15] if name == "camA" else statics[name]
            bus.publish(name, frame, FrameMeta(width=w, height=h, channels=3, timestamp_ms=ts,
                                               is_keyframe=True))
        hand_tick(engine, results_q)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    report["flash_attention_fwd"]["launches_cascade"] = launches["flash_attention_fwd"]
    if sched.head_dispatches < 1:
        raise AssertionError(f"phase 17b: no head pass in {tick} ticks: {sched.snapshot()}")
    pool = sched._pool
    due = sorted(k for k in sched._tracks if pool.full(k))
    plan = pool.gather_indices(due, 4)
    with engine._compute_stream(), torch.inference_mode():
        host, replay_ms = engine._cascade_head(pool, *plan, len(due))
        clips = pool.gather(*plan)
        kernels_seen = launched_kernels(lambda: engine._cascade_head(pool, *plan, len(due)))
        spec, module = engine._ensure_model(CASCADE_LONG_MODEL)
        set_attention(module, plain_attention)
        try:
            plain = _build_cascade_head(module, engine._cfg.cascade_score_w,
                                        engine._cfg.cascade_score_b)(clips)
            torch.cuda.synchronize()
        finally:
            set_attention(module, None)
    flash = [k for k in kernels_seen if "flash_fwd" in k]
    swap_err = float(np.abs(host["logits"] - plain["logits"].cpu().numpy()).max())
    log(f"phase 17b {CASCADE_LONG_MODEL} head on {card}: {len(names)} tracks, first head pass at "
        f"tick {sched.head_ticks[0]} ({tick} ticks in {wall_s:.3f} s), the head "
        f"{head_ms[0]:.3f} ms at its first pass (capture included), {replay_ms:.3f} ms a "
        f"replay (CUDA events, the gather included); "
        f"flash forward launches over the run {launches['flash_attention_fwd']}; one head "
        f"call ran {len(kernels_seen)} device kernels, flash forward {len(flash)} "
        f"({flash[0][:60] if flash else None}); logits with the plain attention swapped in: "
        f"max|d| {swap_err:.4g} (bound VIDEO_SWAP_TOL {VIDEO_SWAP_TOL})")
    if not flash or launches["flash_attention_fwd"] <= 0:
        raise AssertionError(f"phase 17b: the flash forward did not run in the head: "
                             f"{kernels_seen[:20]}, launches {launches}")
    if not swap_err <= VIDEO_SWAP_TOL:
        raise AssertionError(f"phase 17b: head logits {swap_err} from the plain attention's, "
                             f"bound {VIDEO_SWAP_TOL}")
    bus.close()
    del engine, sched, pool, clips, module
    torch.cuda.empty_cache()

    # (c) the harvest's host cost at the main path's load: yolov8n bf16 at
    # 16x1080p (random weights, about 100 tracked detections a frame), one
    # one-crop pack a detection on the drain.
    from video_edge_ai_proxy_tpu_torch.ingest.sources import SyntheticSource
    from video_edge_ai_proxy_tpu_torch.replay.checksum import zero_class_prior

    spec = registry.get(ROI_DET_MODEL)
    model = spec.init_params(torch.Generator().manual_seed(0), device=dev)
    model.load_state_dict(zero_class_prior(model.state_dict()))
    frames = [SyntheticSource.render(h, w, k) for k in range(4)]
    runs = {}
    for cascade in (False, True):
        bus = MemoryFrameBus()
        engine = InferenceEngine(bus, EngineConfig(model=ROI_DET_MODEL, prof=False,
                                                   prefetch=False, cascade=cascade,
                                                   cascade_model=CASCADE_MODEL),
                                 device=dev, model=model, annotations=Sink())
        results_q = hand_engine(engine)
        streams = [f"cam{i:02d}" for i in range(N_STREAMS)]
        for s in streams:
            bus.create_stream(s, h * w * 3)
        dets = 0
        for step in range(CASCADE_HARVEST_TICKS):
            ts = int(time.time() * 1000)
            for i, s in enumerate(streams):
                bus.publish(s, frames[(step + i) % len(frames)], FrameMeta(
                    width=w, height=h, channels=3, timestamp_ms=ts, is_keyframe=True))
            dets += sum(len(r.detections) for r in hand_tick(engine, results_q))
        p = engine.pipeline_stats()
        runs[cascade] = (p, dets, engine.cascade.snapshot() if cascade else None,
                         engine.cascade.pool_nbytes() if cascade else 0)
        bus.close()
        del engine
    (p_on, dets_on, snap, pool_bytes), (p_off, _, _, _) = runs[True], runs[False]
    log(f"phase 17c {ROI_DET_MODEL} {N_STREAMS}x1080p with the cascade's harvest on {card}: "
        f"{CASCADE_HARVEST_TICKS} hand-stepped ticks, {dets_on / max(p_on.frames, 1):.1f} "
        f"tracked detections a frame, {snap['harvested']} tiles harvested into "
        f"{len(snap['tracks'])} tracks (pool {pool_bytes} B); the harvest "
        f"{p_on.harvest_ms / max(p_on.frames, 1):.3f} ms a frame, the emit "
        f"{p_on.emit_ms / max(p_on.frames, 1):.3f} ms a frame with it and "
        f"{p_off.emit_ms / max(p_off.frames, 1):.3f} without")
    del model, runs
    torch.cuda.empty_cache()


# -- phase 18: the other model families --------------------------------------------------

# float32 on the card against float32 on the CPU (TF32 off), the pooled
# 2048-wide ResNet-50 embedding: each entry's difference relative to the
# largest |entry|, as F32_GRAD_REL_TOL is: another convolution order through
# 53 convs gives about 1e-6 of it; 1e-4 is far above that noise.
F32_EMBED_REL_TOL = 1e-4
FLEET = (("yolov8n", 6), ("resnet50", 5), ("vit_b16", 5))   # BASELINE.md's mixed fleet
FLEET_EMBED_WIDTH = 2048     # 18b: resnet50's pooled feature
FLEET_RUN_S = 10.0           # 18b: paced at 30 fps for this long
FLEET_BUCKETS = (1, 2, 4, 8)  # 18b: every bucket a model of at most 6 streams can take
FLEET_CHILD_TIMEOUT_S = 600  # 18b runs in a process of its own (families_phase)


def replay_against_eager(tag: str, engine, eager, inputs: list, src_hw: tuple) -> tuple:
    """Phase 18a: the engine's graphed step of ``inputs[0]``'s key against
    ``eager`` on each input, bit for bit (two distinct inputs must differ);
    (the graphed step, replay median ms by CUDA events)."""
    import torch

    with torch.inference_mode():
        want = [eager(*x) for x in inputs]
        with engine._compute_stream():
            step = engine._step(src_hw, inputs[0][0].shape[0])
            step(*inputs[-1])                  # warmup, capture, replay
            got = [step(*x) for x in inputs]
            torch.cuda.synchronize()
            for i, (g, w) in enumerate(zip(got, want)):
                for k in w:
                    if g[k].dtype != w[k].dtype or not torch.equal(g[k], w[k]):
                        raise AssertionError(f"phase 18a {tag}: input {i}: the graphed {k} "
                                             f"differs from eager")
            if all(torch.equal(got[0][k], got[1][k]) for k in got[0]):
                raise AssertionError(f"phase 18a {tag}: two distinct inputs gave the same "
                                     f"outputs")
            _, replay_ms = median_call_ms(lambda: step(*inputs[0]))
    return step, replay_ms


WALK_FRAMES = ("referrers", "root_paths", "release_engines")   # the walk's own frames


def _describe(obj) -> str:
    import inspect

    name = type(obj).__name__
    if inspect.isfunction(obj) or inspect.ismethod(obj) or isinstance(obj, type):
        name += f"({getattr(obj, '__qualname__', '?')})"
    elif inspect.ismodule(obj):
        name += f"({obj.__name__})"
    elif inspect.isframe(obj) or inspect.isgenerator(obj):
        code = obj.f_code if inspect.isframe(obj) else obj.gi_code
        name += f"({code.co_name})"
    return name


def _walk_frame(r) -> bool:
    import inspect

    return inspect.isframe(r) and r.f_code.co_name in WALK_FRAMES


def referrers(obj, skip, depth: int = 2, _seen: tuple = ()) -> list:
    """What keeps ``obj`` alive: each referrer's type (a function, a frame
    or a generator by its name), and for a dict, list, tuple, cell or bound
    method what holds that in turn, ``depth`` levels up; ``skip``, the
    walk's own frames and lists left out."""
    import gc

    refs = gc.get_referrers(obj)
    seen = _seen + (id(skip), id(refs))
    out = []
    for r in refs:
        if id(r) in seen or _walk_frame(r):
            continue
        name = _describe(r)
        if depth > 1 and (isinstance(r, (dict, list, tuple))
                          or type(r).__name__ in ("cell", "method")):
            name += f"<-[{', '.join(referrers(r, skip, depth - 1, seen)[:4])}]"
        out.append(name)
    del refs
    return out[:8]


def root_paths(obj, skip, max_depth: int = 12, max_nodes: int = 400) -> list:
    """Chains of referrers from ``obj`` up to what roots it, breadth first:
    a module, a class, a frame of running code, or an object no tracked
    container refers to (held from C). ``skip`` and the walk's own frames
    and containers are left out; at most three chains, each as the
    referrers' types, ``obj`` first."""
    import gc
    import inspect
    import sys

    running = set()
    for f in sys._current_frames().values():
        while f is not None:
            running.add(id(f))
            f = f.f_back
    parent = {id(obj): None}
    keep = {id(obj): obj}
    depth = {id(obj): 0}
    queue = [obj]
    own = {id(parent), id(keep), id(depth), id(queue), id(skip), id(running)}
    found = []
    while queue and len(found) < 3 and len(parent) < max_nodes:
        cur = queue.pop(0)
        refs = gc.get_referrers(cur)
        own.add(id(refs))
        live = [r for r in refs if id(r) not in own and not _walk_frame(r)]
        if cur is not obj and (not live or inspect.ismodule(cur) or isinstance(cur, type)
                               or id(cur) in running):
            chain, k = [], id(cur)
            while k is not None:
                chain.append(_describe(keep[k]))
                k = parent[k]
            found.append(list(reversed(chain)))
            continue
        if depth[id(cur)] < max_depth:
            for r in live:
                if id(r) not in parent:
                    parent[id(r)] = id(cur)
                    keep[id(r)] = r
                    depth[id(r)] = depth[id(cur)] + 1
                    queue.append(r)
        del refs, live
    return found


def release_engines(dev, tag: str) -> None:
    """Collect what only reference cycles keep alive, release the device
    state of the stopped engines and graphed steps of earlier phases that
    stay alive (their graphs, graph pools, models and buffers), the cuBLAS
    workspaces and the preprocessing constants (as after phase 8), and
    print what the allocator still reserves."""
    import gc

    import torch

    from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine, _GraphedStep
    from video_edge_ai_proxy_tpu_torch.ops import preprocess as preprocess_mod

    gc.collect()
    before = torch.cuda.memory_reserved(dev)
    released = 0
    objects = gc.get_objects()
    stopped = [obj for obj in objects
               if isinstance(obj, (InferenceEngine, _GraphedStep)) and obj.__dict__
               and getattr(obj, "_thread", None) is None
               and getattr(obj, "_drain_thread", None) is None]
    del objects
    walked = set()
    for i in range(len(stopped)):
        obj = stopped[i]
        if isinstance(obj, InferenceEngine):
            # The walk to the roots (a few seconds) once a model.
            roots = root_paths(obj, stopped) if obj._spec.name not in walked else "as above"
            walked.add(obj._spec.name)
            log(f"phase {tag} before: stopped engine {i} ({obj._spec.name}) held by "
                f"{referrers(obj, stopped)}; rooted by {roots}")
    for obj in stopped:
        obj.__dict__.clear()
        released += 1
    obj = stopped = None
    gc.collect()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    preprocess_mod._constant.cache_clear()
    torch.cuda.empty_cache()
    states: dict = {}
    for seg in torch.cuda.memory_snapshot():
        for blk in seg["blocks"]:
            states[blk["state"]] = states.get(blk["state"], 0) + blk["size"]
    log(f"phase {tag} before: {released} stopped engines and graphed steps of earlier phases "
        f"released; {torch.cuda.memory_allocated(dev) / 2 ** 20:.1f} MiB allocated, "
        f"{torch.cuda.memory_reserved(dev) / 2 ** 20:.1f} MiB reserved ({before / 2 ** 20:.1f} "
        f"before); reserved blocks by state (MiB) "
        + ", ".join(f"{k} {v / 2 ** 20:.1f}" for k, v in sorted(states.items())))


def families_phase(dev, card: str, zero_launches, read_launches, kernels, report) -> None:
    """Phase 18: (a) yolov8s, resnet50's embed step and mobilenet_v2 at full
    width against their plain keep mask, the CPU in float32 and eager; (b)
    the mixed fleet of yolov8n, resnet50 and vit_b16 streams in one engine,
    in a process of its own: after phases 11-17 this one's allocator keeps
    tens of GiB of freed blocks reserved (on the H100, 565 of 577 segments
    of the default pool without an allocated block), which
    ``empty_cache`` does not return and a new engine's streams cannot
    reuse."""
    release_engines(dev, "18a")
    model_families_phase(dev, card, zero_launches, read_launches, report)
    release_engines(dev, "18b")
    report["nms_keep_mask"].update(run_child("--fleet", "18b", FLEET_CHILD_TIMEOUT_S))


def fleet_main() -> int:
    """``chip_smoke.py --fleet``: phase 18b alone, as ``families_phase``
    runs it in a process of its own (the kernels as phase 2 built them);
    the keep mask's report entries are its last line."""
    import torch

    if not torch.cuda.is_available():
        return 1
    sys.path.insert(0, ROOT)
    from video_edge_ai_proxy_tpu_torch.device import resolve_device
    from video_edge_ai_proxy_tpu_torch.kernels import build
    from video_edge_ai_proxy_tpu_torch.kernels.nms import nms_keep_mask_cuda

    build.build_all()

    def zero_launches():
        nms_keep_mask_cuda.launches = 0

    def read_launches():
        return {"nms_keep_mask": nms_keep_mask_cuda.launches}

    report: dict = {"nms_keep_mask": {}}
    mixed_fleet_phase(resolve_device("cuda"), card_line(), zero_launches, read_launches, report)
    print(json.dumps(report["nms_keep_mask"]), flush=True)
    return 0


def model_families_phase(dev, card: str, zero_launches, read_launches, report) -> None:
    """Phase 18a: each new model at full width."""
    import torch

    from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
    from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine, build_serving_step
    from video_edge_ai_proxy_tpu_torch.models import registry
    from video_edge_ai_proxy_tpu_torch.models.carry import zero_class_prior
    from video_edge_ai_proxy_tpu_torch.ops.nms import nms_keep_mask_reference
    from video_edge_ai_proxy_tpu_torch.ops.preprocess import (
        frame_quality_stats, preprocess_classify, preprocess_letterbox,
    )
    from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig

    gen = torch.Generator(device=dev).manual_seed(18)
    frames = [torch.randint(0, 256, (N_STREAMS,) + FRAME_HW + (3,), generator=gen,
                            dtype=torch.uint8, device=dev) for _ in range(2)]
    thumbs = [torch.rand((N_STREAMS, THUMB, THUMB), generator=gen, device=dev) for _ in range(2)]
    inputs = list(zip(frames, thumbs))

    def no_tf32():
        return torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False,
                                          allow_tf32=False)

    def engine_for(name, model):
        engine = InferenceEngine(MemoryFrameBus(), EngineConfig(model=name), device=dev,
                                 model=model)
        engine.warmup()
        return engine

    def f32_pair(spec):
        return (spec.init_params(torch.Generator().manual_seed(0), device=dev,
                                 dtype=torch.float32),
                spec.init_params(torch.Generator().manual_seed(0), device="cpu",
                                 dtype=torch.float32))

    # (a) yolov8s
    spec = registry.get("yolov8s")
    model = spec.init_params(torch.Generator().manual_seed(0), device=dev)
    model.load_state_dict(zero_class_prior(model.state_dict()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    eager = build_serving_step(model, spec, quality_thumb=THUMB)
    out = eager(*inputs[0])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    want_shapes = {"boxes": (16, 100, 4), "scores": (16, 100), "classes": (16, 100),
                   "valid": (16, 100), "quality_stats": (16, 3),
                   "quality_thumbs": (16, THUMB, THUMB)}
    if shapes != want_shapes:
        raise AssertionError(f"phase 18a yolov8s output shapes {shapes} != {want_shapes}")
    for key in ("boxes", "scores", "quality_stats", "quality_thumbs"):
        if not bool(torch.isfinite(out[key]).all()):
            raise AssertionError(f"phase 18a yolov8s: non-finite {key}")
    n_valid = int(out["valid"].sum())
    if n_valid <= 0:
        raise AssertionError("phase 18a yolov8s: no detections")
    ref = build_serving_step(model, spec, quality_thumb=THUMB,
                             keep_mask=nms_keep_mask_reference)(*inputs[0])
    for key in ("boxes", "scores", "classes", "valid"):
        if not torch.equal(out[key], ref[key]):
            raise AssertionError(f"phase 18a yolov8s: the plain keep mask gives another {key}")
    engine = engine_for("yolov8s", model)
    step, replay_ms = replay_against_eager("yolov8s", engine, eager, inputs, FRAME_HW)
    with torch.inference_mode(), engine._compute_stream():
        zero_launches()
        step(*inputs[0])
        torch.cuda.synchronize()
        per_replay = read_launches()["nms_keep_mask"]
    if per_replay != 1:
        raise AssertionError(f"phase 18a yolov8s: {per_replay} keep-mask launches a replay")
    m32, m32_cpu = f32_pair(spec)
    two = frames[0][:2]
    with torch.inference_mode(), no_tf32():
        x_gpu, _ = preprocess_letterbox(two, 640, out_dtype=torch.float32)
        x_cpu, _ = preprocess_letterbox(two.cpu(), 640, out_dtype=torch.float32)
        pre_err = float((x_gpu.cpu() - x_cpu).abs().max())
        head_gpu = m32(x_gpu.permute(0, 3, 1, 2), decode=False)
        head_cpu = m32_cpu(x_cpu.permute(0, 3, 1, 2), decode=False)
        logit_err = max(float((g.cpu() - c).abs().max())
                        for lg, lc in zip(head_gpu, head_cpu) for g, c in zip(lg, lc))
        b_gpu, _ = m32(x_gpu.permute(0, 3, 1, 2), decode=True)
        b_cpu, _ = m32_cpu(x_cpu.permute(0, 3, 1, 2), decode=True)
        s_gpu, _ = frame_quality_stats(two, torch.zeros((2, THUMB, THUMB), device=dev),
                                       (THUMB, THUMB))
        s_cpu, _ = frame_quality_stats(two.cpu(), torch.zeros((2, THUMB, THUMB)),
                                       (THUMB, THUMB))
    box_err = float((b_gpu.cpu() - b_cpu).abs().max())
    stat_err = float((s_gpu.cpu() - s_cpu).abs().max())
    log(f"phase 18a yolov8s bf16 640, {N_STREAMS}x1080x1920 uint8: shapes ok, finite, "
        f"{n_valid} detections, the plain keep mask gives the same; graph replay = eager on "
        f"2 inputs, {replay_ms:.3f} ms a replay (median of 20, CUDA events) on {card}, "
        f"{per_replay} keep-mask launch a replay; peak memory {peak:.1f} MiB (eager); f32 "
        f"card vs CPU (2 frames, TF32 off): preprocess {pre_err:.3g}, head logits "
        f"{logit_err:.3g}, boxes {box_err:.3g} px, quality stats {stat_err:.3g}")
    if not (pre_err <= 1e-4 and logit_err <= F32_LOGIT_TOL and box_err <= 1e-2
            and stat_err <= 1e-4):
        raise AssertionError("phase 18a yolov8s: float32 on the card disagrees with the CPU")
    report["nms_keep_mask"]["replay_ms_yolov8s"] = replay_ms
    del engine, step, eager, model, m32, m32_cpu, out, ref
    torch.cuda.empty_cache()

    # (a) resnet50's embed step
    spec = registry.get("resnet50")
    model = spec.init_params(torch.Generator().manual_seed(0), device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    eager = build_serving_step(model, spec, quality_thumb=THUMB)
    out = eager(*inputs[0])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    emb = out["embedding"]
    if tuple(emb.shape) != (N_STREAMS, 2048) or emb.dtype != torch.float32 \
            or not bool(torch.isfinite(emb).all()):
        raise AssertionError(f"phase 18a resnet50: embedding {tuple(emb.shape)} {emb.dtype}")
    engine = engine_for("resnet50", model)
    _, replay_ms = replay_against_eager("resnet50", engine, eager, inputs, FRAME_HW)
    m32, m32_cpu = f32_pair(spec)
    with torch.inference_mode(), no_tf32():
        e_gpu = m32(preprocess_classify(two, (224, 224), out_dtype=torch.float32),
                    features_only=True).cpu()
        e_cpu = m32_cpu(preprocess_classify(two.cpu(), (224, 224), out_dtype=torch.float32),
                        features_only=True)
    emb_rel = float((e_gpu - e_cpu).abs().max() / e_cpu.abs().max())
    log(f"phase 18a resnet50 embed bf16 224, {N_STREAMS}x1080x1920 uint8: embeddings "
        f"[{N_STREAMS}, 2048] float32, finite (|mean| {float(emb.abs().mean()):.4g}); graph "
        f"replay = eager on 2 inputs, {replay_ms:.3f} ms a replay on {card}; peak memory "
        f"{peak:.1f} MiB (eager); f32 card vs CPU (2 frames, TF32 off): largest difference "
        f"{emb_rel:.3g} of the largest |entry| (tolerance {F32_EMBED_REL_TOL})")
    if not emb_rel <= F32_EMBED_REL_TOL:
        raise AssertionError("phase 18a resnet50: float32 on the card disagrees with the CPU")
    del engine, eager, model, m32, m32_cpu, out, emb
    torch.cuda.empty_cache()

    # (a) mobilenet_v2 classify at 1 stream and at 16
    spec = registry.get("mobilenet_v2")
    model = spec.init_params(torch.Generator().manual_seed(0), device=dev)
    m32, m32_cpu = f32_pair(spec)
    engine = engine_for("mobilenet_v2", model)
    eager = build_serving_step(model, spec, quality_thumb=THUMB)
    notes = []
    for n in (1, N_STREAMS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        sub = [(f[:n], t[:n]) for f, t in inputs]
        _, replay_ms = replay_against_eager(f"mobilenet_v2 x{n}", engine, eager, sub, FRAME_HW)
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
        with torch.inference_mode(), no_tf32():
            got = build_serving_step(m32, spec, preprocess_dtype=torch.float32)(frames[0][:n])
            want = build_serving_step(m32_cpu, spec, preprocess_dtype=torch.float32)(
                frames[0][:n].cpu())
        if not torch.equal(got["top_ids"].cpu(), want["top_ids"]):
            raise AssertionError(f"phase 18a mobilenet_v2 x{n}: f32 top-5 ids on the card "
                                 f"{got['top_ids'].tolist()} != the CPU's "
                                 f"{want['top_ids'].tolist()}")
        p_err = float((got["top_probs"].cpu() - want["top_probs"]).abs().max())
        notes.append(f"{n} stream(s): replay = eager, {replay_ms:.3f} ms a replay, peak "
                     f"{peak:.1f} MiB; f32 top-5 ids equal card vs CPU (probabilities "
                     f"{p_err:.3g} apart)")
    log(f"phase 18a mobilenet_v2 classify bf16 224 on {card}: " + "; ".join(notes))
    del engine, eager, model, m32, m32_cpu, frames, thumbs, inputs
    torch.cuda.empty_cache()


def mixed_fleet_phase(dev, card: str, zero_launches, read_launches, report) -> None:
    """Phase 18b: one engine serving ``FLEET``'s streams, each on its model
    (the first, a detector, the engine's default)."""
    import torch

    from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
    from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine
    from video_edge_ai_proxy_tpu_torch.ingest.sources import SyntheticSource
    from video_edge_ai_proxy_tpu_torch.models import registry
    from video_edge_ai_proxy_tpu_torch.models.carry import zero_class_prior
    from video_edge_ai_proxy_tpu_torch.obs import registry as obs_registry
    from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig

    default = FLEET[0][0]
    streams = {f"{name}-{i}": name for name, n in FLEET for i in range(n)}
    bus = MemoryFrameBus()
    for s in streams:
        bus.create_stream(s, FRAME_HW[0] * FRAME_HW[1] * 3)
    det = registry.get(default).init_params(torch.Generator().manual_seed(0), device=dev)
    det.load_state_dict(zero_class_prior(det.state_dict()))
    cfg = EngineConfig(model=default, prewarm=[[FRAME_HW[0], FRAME_HW[1], b, m]
                                               for m, _ in FLEET for b in FLEET_BUCKETS])
    engine = InferenceEngine(bus, cfg, device=dev, model=det,
                             model_resolver=lambda d: "" if streams.get(d) == default
                             else streams.get(d, ""))
    results = engine.subscribe()
    got: dict = {}

    def consume():
        for r in results:
            got.setdefault(r.device_id, []).append(r)

    reader = threading.Thread(target=consume, daemon=True)
    reader.start()
    pool = [SyntheticSource.render(FRAME_HW[0], FRAME_HW[1], n) for n in range(PACED_POOL)]
    device_ms = {f.name: f for f in obs_registry.families()}["vep_device_batch_ms"]
    torch.cuda.reset_peak_memory_stats(dev)
    with LogCounter() as logged:
        t0 = time.perf_counter()
        engine.start()
        start_s = time.perf_counter() - t0
        batches0 = device_ms.labels(default).count
        zero_launches()
        try:
            published, wall_s, _ = paced_publish(bus, list(streams), pool, FLEET_RUN_S)
        finally:
            engine.stop()
        launches = read_launches()
        batches = device_ms.labels(default).count - batches0
    reader.join(10)
    if reader.is_alive():
        raise AssertionError("phase 18b: the subscriber did not end")
    failures = {m: logged.count(m) for m in FAILURE_MESSAGES}
    missing = [s for s in streams if not got.get(s)]
    misrouted = [(s, r.model) for s, rs in got.items() for r in rs if r.model != streams[s]]
    bad_emb = [s for s, rs in got.items() if registry.get(streams[s]).kind == "embed"
               for r in rs if not (len(r.detections) == 1
                                   and len(r.detections[0].embedding) == FLEET_EMBED_WIDTH)]
    by_model = {}
    for s, rs in got.items():
        by_model.setdefault(streams[s], []).extend(r.latency_ms for r in rs)
    log(f"phase 18b mixed fleet on {card}: {', '.join(f'{n} {m}' for m, n in FLEET)} streams "
        f"at {FRAME_HW[1]}x{FRAME_HW[0]}, {PACED_FPS:g} fps for {wall_s:.3f} s ({published} frames published; "
        f"start with {len(cfg.prewarm)} programs prewarmed {start_s:.2f} s): " + "; ".join(
            f"{m} {len(lat)} results ({len(lat) / wall_s:.2f} frames/s), latency p50 "
            f"{pct(lat, 50):.3f} ms, p95 {pct(lat, 95):.3f} ms" for m, lat in by_model.items())
        + f"; keep-mask launches {launches['nms_keep_mask']} for {batches} {default} batches; "
        f"{len(misrouted)} misrouted; peak memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2 ** 20:.1f} MiB; logged failures {failures} "
        f"({logged.summary()})")
    if missing or misrouted or bad_emb or any(failures.values()):
        raise AssertionError(f"phase 18b: streams without results {missing}, misrouted "
                             f"{misrouted[:5]}, embed streams without a {FLEET_EMBED_WIDTH}-wide "
                             f"embedding {sorted(set(bad_emb))}, failures {failures}")
    if launches["nms_keep_mask"] != batches or batches <= 0:
        raise AssertionError(f"phase 18b: {launches['nms_keep_mask']} keep-mask launches for "
                             f"{batches} {default} batches")
    report["nms_keep_mask"]["launches_fleet"] = launches["nms_keep_mask"]
    del engine, det
    torch.cuda.empty_cache()


SOAK_S = 20.0                # 19b-d: each soak's measured window
SOAK_TRACE_FRAMES = 60       # 19: the recorded trace the cameras loop (2 s at 30 fps)
SOAK_LOCKSTEP_FRAMES = 8     # 19a: frames a stream in the determinism trace (11a's depth)
SOAK_QUALITY_BOUND_S = 5.0   # 19d: the soak tools' detection-latency bound
SOAK_CHILD_TIMEOUT_S = 600   # 19 runs in a process of its own
E2E_MODEL = "yolov8n"        # 20: the default EngineConfig's model
E2E_S = 20.0                 # 20: the measured window after the warmup
E2E_WARMUP_S = 15.0          # 20: the worker's boot and the engine's first batches
E2E_LATENCY_LIMIT_MS = 40.0  # PERF.md section 2's p50 limit, printed beside the run
E2E_CHILD_TIMEOUT_S = 300    # 20 runs in a process of its own


def run_child(flag: str, tag: str, timeout_s: float, *args: str) -> dict:
    """``chip_smoke.py <flag> [args]`` in a process of its own: its lines
    logged here, its last line (a JSON object) returned; a non-zero exit
    raises."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), flag, *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout_s)
    lines = proc.stdout.splitlines()
    for line in lines[:-1]:
        log(line)
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"phase {tag} exited {proc.returncode}: {proc.stderr[-3000:]}")
    return json.loads(lines[-1])


class LaunchesAfterStart:
    """While entered, every ``InferenceEngine.start()`` zeroes the kernels'
    launch counts and takes the detector's batch count as its base when it
    returns: the prewarm's eager warmup calls launch the keep mask but are
    no batch of the main path. ``launches``/``batches`` read what the
    engines ran since."""

    def __init__(self, zero_launches, read_launches, model: str):
        from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine

        self._cls = InferenceEngine
        self._zero, self._read = zero_launches, read_launches
        self._model = model
        self._base = 0

    def _count(self) -> int:
        from video_edge_ai_proxy_tpu_torch.obs import registry as obs_registry

        hist = {f.name: f for f in obs_registry.families()}["vep_device_batch_ms"]
        return hist.labels(self._model).count

    def __enter__(self):
        orig = self._orig = self._cls.start

        def start(engine):
            orig(engine)
            self._zero()
            self._base = self._count()

        self._cls.start = start
        return self

    def __exit__(self, *exc):
        self._cls.start = self._orig

    def launches(self) -> int:
        return self._read()["nms_keep_mask"]

    def batches(self) -> int:
        return self._count() - self._base


def tool_module(name: str):
    """``tools/<name>.py`` as a module: its gates."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools",
                                                                     f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def soak_gates(tag: str, soak: dict, counted: LaunchesAfterStart, failures: dict) -> list:
    """The gates every soak leg of phase 19 holds: tools/torch_soak_replay.py's
    chaos gates (no misrouted result, the uplink conserved and drained, the
    drop budget) and the script's own."""
    bad = tool_module("torch_soak_replay").chaos_failures(soak, soak["duration_s"])
    # The quality leg's canary stream is served beside the cameras.
    canary = 1 if soak["quality"] is not None else 0
    if soak["streams_with_results"] != soak["streams"] + canary:
        bad.append(f"{soak['streams_with_results']} streams with results, {soak['streams']} "
                   f"cameras and {canary} canary")
    if not soak["step_cache"]["stable"]:
        bad.append(f"step cache not stable: {soak['step_cache']['samples']}")
    if counted.launches() != counted.batches() or counted.batches() <= 0:
        bad.append(f"{counted.launches()} keep-mask launches for {counted.batches()} detector "
                   f"batches")
    if any(failures.values()):
        bad.append(f"logged failures {failures}")
    return [f"phase {tag}: {b}" for b in bad]


def soak_line(tag: str, card: str, soak: dict, counted: LaunchesAfterStart, logged,
              failures: dict, seconds: float) -> None:
    """Phase 19's report of one soak leg."""
    import torch

    dur = soak["duration_s"]
    fams = "; ".join(
        f"{fam} p50 {p['p50']} ms, p95 {p['p95']} ms, p99 {p['p99']} ms ({p['n']} results)"
        for fam, p in soak["per_family_latency_ms"].items() if p)
    fills = ", ".join(f"{b['t_s']}s {b['fill']}" for b in soak["bucket_fill_timeline"])
    cams = ", ".join(f"{d} {n / dur:.2f}" for d, n in soak["published"].items())
    uplink = soak["resilience"]["uplink"]
    log(f"phase {tag} on {card}: {soak['streams']} streams {soak['fleet']} at "
        f"{soak['src_hw'][1]}x{soak['src_hw'][0]} for {dur:g} s ({seconds:.1f} s in all, "
        f"warmup {soak['warmup_s']} s): {soak['results_measured']} results "
        f"({soak['results_measured'] / dur:.2f}/s); {fams}; bucket fill by {10:g} s bin: "
        f"{fills}; published frames/s per camera (30 offered): {cams}; suppressed "
        f"{soak['suppressed']}; subscriber drops {soak['subscriber_drops']} (budget "
        f"{int(dur * soak['streams'] * 30.0)}); step cache {soak['step_cache']['final']} "
        f"programs, stable {soak['step_cache']['stable']}; faults {soak['faults_applied']}; "
        f"ladder {soak['resilience']['ladder']}; shed {soak['resilience']['shed_frames']}; "
        f"uplink published {uplink['published']}, delivered {uplink['delivered_events']}, "
        f"post failures {uplink['post_failures']}, breaker {uplink['breaker']}, spooled "
        f"{uplink['spool']['spooled_batches']} batches, conserved {uplink['conserved']}; "
        f"keep-mask launches {counted.launches()} for {counted.batches()} detector batches; "
        f"{soak['ticks']} ticks; logged failures {failures} ({logged.summary()}); "
        f"{torch.cuda.memory_allocated() / 2 ** 20:.1f} MiB allocated, "
        f"{torch.cuda.memory_reserved() / 2 ** 20:.1f} MiB reserved after it")


def soak_phase(dev, card: str, zero_launches, read_launches, report: dict) -> None:
    """Phase 19: the chaos soak of the north-star fleet at full width."""
    import gc
    import shutil
    import tempfile

    import torch

    from video_edge_ai_proxy_tpu_torch.replay.faults import QUALITY_KINDS, FaultPlan
    from video_edge_ai_proxy_tpu_torch.replay.harness import (
        FLEET_CUDA, lockstep_checksum, run_fleet_soak,
    )
    from video_edge_ai_proxy_tpu_torch.replay.recorder import record_synthetic_trace

    h, w = FRAME_HW
    detector = next(iter(FLEET_CUDA))
    model_of = {f"fleet{i:02d}": m for i, m in enumerate(
        m for m, n in FLEET_CUDA.items() for _ in range(n))}
    streams = sorted(model_of)
    tmp = tempfile.mkdtemp(prefix="vep_soak_smoke_")
    try:
        # (a) determinism: 16 streams of 1080p, replayed twice.
        lock_trace = record_synthetic_trace(os.path.join(tmp, "lockstep.vtrace"), streams,
                                            width=w, height=h, frames=SOAK_LOCKSTEP_FRAMES)
        t0 = time.perf_counter()
        runs = [lockstep_checksum(lock_trace, model=detector, device=dev) for _ in range(2)]
        log(f"phase 19a lockstep_checksum on {card}: {len(streams)} streams x "
            f"{SOAK_LOCKSTEP_FRAMES} frames at {w}x{h}, {detector} bf16: folds "
            f"{runs[0]['checksum']} and {runs[1]['checksum']} ({runs[0]['batches']} batches "
            f"each, {time.perf_counter() - t0:.1f} s)")
        if runs[0]["checksum"] != runs[1]["checksum"] or runs[0]["batches"] <= 0:
            raise AssertionError(f"phase 19a: two replays folded {runs[0]['checksum']} and "
                                 f"{runs[1]['checksum']}")
        del runs
        soak_trace = record_synthetic_trace(os.path.join(tmp, "soak.vtrace"), streams,
                                            width=w, height=h, frames=SOAK_TRACE_FRAMES)
        launches = 0
        for tag, plan, quality in (
                ("19b", None, ()),
                ("19c", FaultPlan.resilience(SOAK_S), ()),
                ("19d", None, QUALITY_KINDS)):
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            with LogCounter() as logged, \
                    LaunchesAfterStart(zero_launches, read_launches, detector) as counted:
                soak = run_fleet_soak(duration_s=SOAK_S, fleet=dict(FLEET_CUDA),
                                      src_hw=FRAME_HW, tick_ms=10, trace_path=soak_trace,
                                      fault_plan=plan, quality_kinds=quality, device=dev)
            failures = {m: logged.count(m) for m in FAILURE_MESSAGES}
            soak_line(tag, card, soak, counted, logged, failures, time.perf_counter() - t0)
            bad = soak_gates(tag, soak, counted, failures)
            launches += counted.launches()
            if tag == "19b":
                killed = next(f["device_id"] for f in soak["faults_applied"]
                              if f["kind"] == "camera_kill")
                if soak["suppressed"][killed] <= 0:
                    bad.append(f"phase 19b: the killed camera {killed} suppressed nothing")
            if tag == "19c":
                breaker = soak["resilience"]["uplink"]["breaker"]
                log(f"phase 19c ladder transitions {soak['resilience']['ladder']}; breaker "
                    f"transitions {breaker['transitions']}, state {breaker['state']}")
                if not breaker["transitions"].get("open") or breaker["state"] != "closed":
                    bad.append(f"phase 19c: the breaker did not open and close: {breaker}")
            if tag == "19d":
                q = soak["quality"] or {}
                qsnap = soak["obs"]["quality"] or {"streams": {}}
                black = next((f["device_id"] for f in q.get("faults", [])
                              if f["kind"] == "black_frame"), "")
                det = {d: qsnap["streams"].get(d, {}).get("det_ema", 0.0)
                       for d in streams if model_of[d] == detector}
                log(f"phase 19d quality: faults {q.get('faults')}; false positives "
                    f"{q.get('false_positives')}; canary {q.get('canary')}; canary episodes "
                    f"{q.get('canary_watchdog_episodes')}; {detector} detections a frame (EMA) "
                    f"{det}")
                if len(q.get("faults", [])) != len(QUALITY_KINDS):
                    bad.append(f"phase 19d: quality section {q}")
                else:
                    bad += [f"phase 19d: {f}" for f in tool_module("torch_soak_replay").quality_failures(
                        q, QUALITY_KINDS, SOAK_QUALITY_BOUND_S)]
                if not all(v > 0 for d, v in det.items() if d != black):
                    bad.append(f"phase 19d: {detector} streams without detections {det}")
            del soak
            if bad:
                raise AssertionError("; ".join(bad))
        report["launches_soak"] = launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def e2e_phase(dev, card: str, zero_launches, read_launches, report: dict) -> None:
    """Phase 20: ``run_e2e`` of ``E2E_MODEL`` at 1080p, publish -> gRPC client."""
    from video_edge_ai_proxy_tpu_torch.replay.harness import run_e2e

    import shutil

    # The server's data directory (the worker's log among it) is kept here.
    workdir = os.path.join(ROOT, "chiprun_out", "phase20")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    t0 = time.perf_counter()
    with LogCounter() as logged, \
            LaunchesAfterStart(zero_launches, read_launches, E2E_MODEL) as counted:
        e2e = run_e2e(duration_s=E2E_S, warmup_s=E2E_WARMUP_S, width=FRAME_HW[1],
                      height=FRAME_HW[0], model=E2E_MODEL, workdir=workdir, device=dev.type)
    failures = {m: logged.count(m) for m in FAILURE_MESSAGES}
    lat = e2e["latency_ms"] or {}
    stages = {k: {q: v.get(q) for q in ("count", "p50", "p90", "p99")}
              for k, v in e2e["obs"]["stage_breakdown"].items() if isinstance(v, dict)}
    log(f"phase 20 run_e2e on {card}: {E2E_MODEL} at {FRAME_HW[1]}x{FRAME_HW[0]}, one replay:// "
        f"worker at 30 fps on the shm bus, gRPC Inference to a client thread, {E2E_S:g} s "
        f"after {E2E_WARMUP_S:g} s ({time.perf_counter() - t0:.1f} s in all): "
        f"{e2e['results_measured']} results measured of {e2e['results_total']}; publish -> "
        f"client-receive p50 {lat.get('p50')} ms, p90 {lat.get('p90')}, p95 {lat.get('p95')}, "
        f"p99 {lat.get('p99')} (limit {E2E_LATENCY_LIMIT_MS:g} ms at p50, not gated); stages "
        f"{stages}; keep-mask launches {counted.launches()} for {counted.batches()} "
        f"{E2E_MODEL} batches; logged failures {failures} ({logged.summary()})")
    if e2e["results_measured"] <= 0 or counted.launches() <= 0 or \
            counted.launches() != counted.batches() or any(failures.values()):
        raise AssertionError(f"phase 20: {e2e['results_measured']} results, "
                             f"{counted.launches()} keep-mask launches for {counted.batches()} "
                             f"batches, failures {failures}")
    report["launches_e2e"] = counted.launches()


# -- phase 22: the fleet tier -----------------------------------------------------------------

FLEET_TIER_MODEL = "yolov8n"          # 22b-d: each member's default model
FLEET_TIER_TENANT = "mobilenet_v2"    # 22d: LoadShape's second tenant
FLEET_TIER_THREADS = 2                # each member's torch intra-op threads
FLEET_OBS_MEMBERS = 3                 # 22b (FLEETOBS_r01.json's)
FLEET_OBS_S = 12.0                    # 22b: each member's window after its warmup
FLEET_OBS_WARMUP_S = 8.0              # 22b: the worker boot (JAX tool default)
FLEET_OBS_FPS = 30.0
ROUTER_MEMBERS = 3                    # 22c (ROUTER_r01.json's)
ROUTER_STREAMS_PER_MEMBER = 2
ROUTER_FPS = 2.0
ROUTER_SCRAPE_S = 1.0
ROUTER_ESCALATE_S = 8.0
AUTOSCALE_HORIZON_S = 600.0           # 22d: tools/autoscale_smoke.py's --spawn-horizon
FLEET_TIER_CHILD_TIMEOUT_S = 600      # 22 runs in a process of its own


def member_lines(tag: str, runs: dict, card: str) -> tuple:
    """Log each member of a fleet-tier leg (boot s, first frame s, device ms
    a batch at p50, peak reserved memory, torch threads, keep-mask launches
    against its ``yolov8n`` batches over the served window: from its ready
    line, whose counts hold the boot's captures and warm-up batches, to its
    last counts); returns (the members' keep-mask launches over their
    windows in all, the members failing ``launches == batches > 0``)."""
    total = 0
    bad = []
    for name, run in sorted(runs.items()):
        c = run.get("counts") or {}
        base = run.get("ready_counts") or {}
        launches = batches = None
        if c:
            launches = ((c.get("launches") or {}).get("nms_keep_mask", 0)
                        - (base.get("launches") or {}).get("nms_keep_mask", 0))
            batches = ((c.get("batches") or {}).get(FLEET_TIER_MODEL, 0)
                       - (base.get("batches") or {}).get(FLEET_TIER_MODEL, 0))
        reserved = c.get("max_memory_reserved")
        log(f"phase {tag} member {name} on {card}: boot {run.get('boot_s')} s (main -> "
            f"Server built, -> model and kernels, -> started: {run.get('boot_split_s')}), "
            f"first frame {run.get('first_frame_s')} s after its Popen, device ms a batch at "
            f"p50 {c.get('device_ms_p50')}, peak reserved "
            f"{reserved / 2 ** 20 if reserved is not None else None} MiB, torch threads "
            f"{c.get('torch_threads', run.get('torch_threads'))}, keep-mask launches {launches} "
            f"for {batches} {FLEET_TIER_MODEL} batches served after its ready line (at ready: "
            f"{base}; batches by model at the end {c.get('batches')}); graph captures s "
            f"{c.get('capture_s')}, subscriber drops {c.get('subscriber_drops')}")
        total += launches or 0
        if not (launches is not None and launches == batches > 0):
            bad.append((name, launches, batches))
    return total, bad


def fleet_tier_phase(dev, card: str, zero_launches, read_launches, report: dict) -> None:
    """Phase 22: the fleet tier on the one card. (a) the capacity smoke;
    (b) the fleet telemetry soak; (c) the router soak; (d) the autoscale
    soak: each gated as the JAX artifact of its tool, each member a process
    of its own on the card."""
    import torch

    from video_edge_ai_proxy_tpu_torch.kernels import launch_counters
    from video_edge_ai_proxy_tpu_torch.replay.harness import (
        LoadShape, run_autoscale_soak, run_fleet_obs, run_router_soak,
    )

    import shutil

    # Each leg's directory (member stderr, span dumps, traces) is kept.
    out_dir = os.path.join(ROOT, "chiprun_out", "phase22")
    shutil.rmtree(out_dir, ignore_errors=True)

    def leg_dir(leg: str) -> str:
        path = os.path.join(out_dir, leg)
        os.makedirs(path)
        return path

    free, total = torch.cuda.mem_get_info()
    log(f"phase 22 card: {card}; torch.cuda.mem_get_info() at the child's start: free "
        f"{free / 2 ** 30:.2f} GiB of {total / 2 ** 30:.2f} GiB")
    h, w = FRAME_HW
    t_phase = time.perf_counter()
    members_launches = 0
    failures = []

    # (a) capacity: part A on the card, B and C on the host.
    cap = tool_module("torch_capacity_smoke")
    t0 = time.perf_counter()
    zero_launches()
    before = {wr.__name__: wr.launches for wr in launch_counters()}
    part_a = cap.part_a("cuda", (w, h))
    torch.cuda.synchronize()
    a_launches = read_launches()["nms_keep_mask"]
    # The cascade head's attention goes to the flash forward or not, as
    # phase 17a configures it: its launches are reported either way.
    flash = {wr.__name__.removesuffix("_cuda"): wr.launches - before[wr.__name__]
             for wr in launch_counters() if wr.__name__.startswith("flash")}
    part_b, part_c = cap.part_b(), cap.part_c()
    torch.cuda.empty_cache()
    a_fail = cap.capacity_failures(part_a, part_b, part_c)
    log(f"phase 22a capacity on {card} ({time.perf_counter() - t0:.1f} s): {part_a['model']} "
        f"{part_a['size'][0]}x{part_a['size'][1]}, {part_a['cascade_model']} head every 4 ticks, {part_a['ticks']} hand-stepped "
        f"ticks in {part_a['wall_s']} s: streams {part_a['streams']}, kinds {part_a['kinds']}, "
        f"per stream ms by kind {part_a['by_stream']}; conservation {part_a['conservation']}; "
        f"headroom {part_a['headroom']}, utilization (fast) {part_a['utilization_fast']}; cells "
        f"{part_a['cells']}; ledger tap {part_a['ledger_tap_mean_us']} us mean over "
        f"{part_a['ledger_taps']} taps = {part_a['ledger_tap_pct_of_tick_budget']}% of the "
        f"10 ms tick; keep-mask launches {a_launches}, the flash kernels' {flash}")
    log(f"phase 22a forecast (host): tts {part_b['tts_first_s']:.3f} -> "
        f"{part_b['tts_last_s']:.3f} s monotone {part_b['tts_monotone_decreasing']}, min "
        f"headroom {part_b['min_headroom']}; admission storm {part_c['storm_by_member']}, "
        f"ties {part_c['tie_placements']} deterministic {part_c['tie_deterministic']}, hash "
        f"fallback deterministic {part_c['hash_fallback_deterministic']}")
    if a_launches <= 0:
        a_fail.append(f"no keep-mask launch in part A ({a_launches})")
    failures += [f"22a: {f}" for f in a_fail]
    report["launches_capacity"] = a_launches

    # (b) fleet telemetry.
    t0 = time.perf_counter()
    fleet = run_fleet_obs(n_members=FLEET_OBS_MEMBERS, duration_s=FLEET_OBS_S,
                          warmup_s=FLEET_OBS_WARMUP_S, width=w, height=h, fps=FLEET_OBS_FPS,
                          model=FLEET_TIER_MODEL, device="cuda",
                          torch_threads=FLEET_TIER_THREADS, workdir=leg_dir("fleet_obs"))
    log(f"phase 22b run_fleet_obs on {card} ({time.perf_counter() - t0:.1f} s): "
        f"{fleet['members']} members x one {w}x{h} stream at {FLEET_OBS_FPS:g} fps, "
        f"{FLEET_OBS_S:g} s after {FLEET_OBS_WARMUP_S:g} s: gates {fleet['gates']}; client "
        f"results {fleet['client_results']}, trace ids {fleet['client_trace_ids']}; counters "
        f"gated {fleet['counters_gated']}; merged page {fleet['merged_exposition_lines']} lines; "
        f"health {[(r['instance'], r['score'], r['up'], r['stale']) for r in fleet['health']]}")
    n, bad = member_lines("22b", fleet["member_runs"], card)
    members_launches += n
    failures += [f"22b: {f}" for f in tool_module("torch_soak_replay").fleet_failures(fleet)]
    failures += [f"22b: member {b[0]}: {b[1]} keep-mask launches for {b[2]} batches"
                 for b in bad]

    # (c) the router.
    t0 = time.perf_counter()
    router = run_router_soak(n_members=ROUTER_MEMBERS,
                             streams_per_member=ROUTER_STREAMS_PER_MEMBER, width=w, height=h,
                             fps=ROUTER_FPS, model=FLEET_TIER_MODEL,
                             scrape_interval_s=ROUTER_SCRAPE_S,
                             ladder_escalate_s=ROUTER_ESCALATE_S, device="cuda",
                             torch_threads=FLEET_TIER_THREADS, workdir=leg_dir("router"))
    log(f"phase 22c run_router_soak on {card} ({time.perf_counter() - t0:.1f} s): "
        f"{router['members']} members, {router['streams']} streams at {ROUTER_FPS:g} fps: gates "
        f"{router['gates']}; burn: {router['burn']['member']} evacuated in "
        f"{router['burn']['migrate_s']} s, transitions at migration "
        f"{router['burn']['transitions_at_migration']}; kill: {router['kill']['member']} "
        f"detect -> resumed {router['kill']['replace_detect_s']} s, wall "
        f"{router['kill']['replace_wall_s']} s, its workers reaped after it "
        f"{router['kill']['orphan_workers_reaped']}; ledger "
        f"{ {k: router['ledger'][k] for k in ('balanced', 'lost', 'duplicated')} }; "
        f"{len(router['lineage'])} migrations with lineage; streams not balanced "
        f"{[r for r in router['ledger']['streams'] if r['lost'] or r['duplicated']]}; "
        f"migrations {router['router_snapshot']['migrations']}")
    n, bad = member_lines("22c", router["member_runs"], card)
    members_launches += n
    failures += [f"22c: {f}" for f in tool_module("torch_router_smoke").router_failures(router)]
    failures += [f"22c: member {b[0]}: {b[1]} keep-mask launches for {b[2]} batches"
                 for b in bad]

    # (d) the autoscaling supervisor.
    t0 = time.perf_counter()
    autoscale = tool_module("torch_autoscale_smoke")
    with open(os.path.join(ROOT, "AUTOSCALE_r01.json")) as f:
        ref_spawn = json.load(f)["spawn"]["event"]
    auto = run_autoscale_soak(width=w, height=h, model=FLEET_TIER_MODEL,
                              spawn_horizon_s=AUTOSCALE_HORIZON_S,
                              shape=LoadShape(models=("", FLEET_TIER_TENANT)),
                              ref_spawn_headroom=autoscale.reference_spawn_headroom(),
                              device="cuda", torch_threads=FLEET_TIER_THREADS,
                              workdir=leg_dir("autoscale"))
    cfg = auto["config"]
    base = cfg["base_min_headroom"]
    # The reference spawn's fleet tts on this device's scale: the horizon's
    # factor applied to the artifact's.
    scale = cfg["spawn_horizon_s_used"] / cfg["spawn_horizon_s"]
    log(f"phase 22d run_autoscale_soak on {card} ({time.perf_counter() - t0:.1f} s): gates "
        f"{auto['gates']}; horizon {cfg['spawn_horizon_s_used']:.1f} s used (the artifact's "
        f"{cfg['spawn_horizon_s']:g} s x (h {base} / ref {cfg['ref_spawn_headroom']}) x "
        f"((1 - ref) / (1 - h)), h the members' min headroom after the base warmup, ref "
        f"AUTOSCALE_r01.json's spawn headroom); the artifact's spawn at pass {ref_spawn['pass']}, "
        f"fleet tts {ref_spawn['fleet_tts_s']:.1f} s ({ref_spawn['fleet_tts_s'] * scale:.1f} s "
        f"scaled), headroom {ref_spawn['min_headroom']} (expected here: about h); LoadShape "
        f"rates as AUTOSCALE_r01.json's ({auto['shape']}); spawn {auto['spawn']['event']}, boot "
        f"{auto['spawn']['boot_s']} s, first frame {auto['spawn']['first_frame_s']} s, prewarm "
        f"{auto['spawn']['prewarm']}; storm first frames {auto['storm']['admitted_first_frame_s']} "
        f"(p99 {auto['storm']['p99_s']} s); retire {auto['retire']['event']}; ledger "
        f"{ {k: auto['ledger'][k] for k in ('balanced', 'lost', 'duplicated')} }; admission "
        f"failures {auto['failures']}; admitted onto {auto['admitted']}; "
        f"migrations {auto['migrations']}; supervisor events "
        f"{auto['supervisor_snapshot'].get('events')}")
    n, bad = member_lines("22d", auto["member_runs"], card)
    members_launches += n
    failures += [f"22d: {f}" for f in autoscale.autoscale_failures(auto)]
    failures += [f"22d: member {b[0]}: {b[1]} keep-mask launches for {b[2]} batches"
                 for b in bad]

    log(f"phase 22 took {time.perf_counter() - t_phase:.1f} s")
    report["launches_fleet_tier"] = members_launches   # 22b-d, the served windows
    if failures:
        raise AssertionError("phase 22: " + "; ".join(failures))


# -- phase 21: the camera tier -------------------------------------------------------------

CAMERA_MODEL = "yolov8n"         # 21: the default EngineConfig's model
CAMERA_FOLDS = (305268384, 304869744)   # 11a's and 11b's folds (11a's trace, seeded yolov8n)
CAMERA_REDIS_CAMS = 4            # 21a: the Server's worker processes on the Redis bus
CAMERA_REDIS_S = 15.0            # 21a: the Server's measured window
CAMERA_DECODE_S = 20.0           # 21b: the engine reads the decoding workers this long
CAMERA_HW = FRAME_HW             # 21b, 21c: the encoded clip's geometry
CAMERA_STREAMS = N_STREAMS       # 21b: decoding worker processes
CAMERA_CLIP_FRAMES = 90          # 21b, 21c: the clip, 3 s at 30 fps
CAMERA_CLIP_GOP = 30
CAMERA_ENCODERS = ("libx264", "libopenh264")   # H.264 encoders libav may offer
CAMERA_RELAY_TOGGLE = 45         # 21c: the relay turns on at this grab, mid-GOP
CAMERA_CHILD_TIMEOUT_S = 600     # 21 runs in a process of its own
# A decoding worker: the worker's own entry point, then its process's
# vep_source_opens_total by kind as its last line (the counter lives in the
# worker's process).
CAMERA_WORKER = ("import json\n"
                 "from video_edge_ai_proxy_tpu_torch.ingest import worker\n"
                 "from video_edge_ai_proxy_tpu_torch.obs import registry\n"
                 "worker.main()\n"
                 "fam = {f.name: f for f in registry.families()}.get('vep_source_opens_total')\n"
                 "print(json.dumps({k: fam.labels(k).value if fam else 0.0\n"
                 "                  for k in ('packet', 'opencv', 'synthetic')}), flush=True)\n")


def libav_probe() -> tuple:
    """(the FFmpeg development headers found, the line that says so and
    whether ``cv2`` imports): ``g++ -E`` of a file that only includes the
    three headers the libav shim compiles against."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "probe.cc")
        with open(src, "w") as fh:
            fh.write("#include <libavformat/avformat.h>\n#include <libavcodec/avcodec.h>\n"
                     "#include <libswscale/swscale.h>\n")
        try:
            proc = subprocess.run(["g++", "-E", src, "-o", os.devnull], capture_output=True,
                                  text=True, timeout=120)
            found = proc.returncode == 0
            why = "" if found else (proc.stderr.strip().splitlines() or ["?"])[-3:]
        except FileNotFoundError as exc:
            found, why = False, f"g++ absent ({exc})"
    try:
        import cv2

        cv = f"cv2 {cv2.__version__} imports"
    except ImportError as exc:
        cv = f"cv2 does not import ({exc})"
    line = (f"phase 21 libav: the FFmpeg development headers (libavformat/avformat.h, "
            f"libavcodec/avcodec.h, libswscale/swscale.h) are "
            + ("found by g++ -E; 21b and 21c run" if found else
               f"absent (g++ -E: {why}): 21b and 21c do not run on this machine, the libav "
               f"shim cannot build here")
            + f"; {cv} (not used: no decode falls back to OpenCV)")
    return found, line


def seeded_detector(dev):
    """yolov8n from seed 0 with the class prior zeroed: 11a's weights."""
    import torch

    from video_edge_ai_proxy_tpu_torch.models import registry
    from video_edge_ai_proxy_tpu_torch.replay.checksum import zero_class_prior

    model = registry.get(CAMERA_MODEL).init_params(torch.Generator().manual_seed(0), device=dev)
    model.load_state_dict(zero_class_prior(model.state_dict()))
    return model


def start_miniredis():
    """The port's MiniRedis in a process of its own (it does not share the
    engine's interpreter lock): (process, address)."""
    proc = subprocess.Popen([sys.executable, "-m", "video_edge_ai_proxy_tpu_torch.bus.miniredis",
                             "--port", "0"], cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                            stdout=subprocess.PIPE, text=True)
    addr = proc.stdout.readline().strip()
    if proc.poll() is not None or ":" not in addr:
        raise AssertionError(f"phase 21a: MiniRedis did not start ({proc.poll()}, {addr!r})")
    return proc, addr


def redis_replay_phase(dev, card: str, model, addr: str, zero_launches, read_launches) -> None:
    """21a, first half: 11a's trace through ``lockstep_checksum`` and through
    the engine's ``serve_lockstep`` over a RedisFrameBus: 11a's and 11b's
    folds."""
    import tempfile

    from video_edge_ai_proxy_tpu_torch.bus.redis_bus import RedisFrameBus
    from video_edge_ai_proxy_tpu_torch.bus.resp import RespClient
    from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine
    from video_edge_ai_proxy_tpu_torch.replay.harness import lockstep_checksum
    from video_edge_ai_proxy_tpu_torch.replay.player import TracePlayer
    from video_edge_ai_proxy_tpu_torch.replay.recorder import record_synthetic_trace
    from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig

    streams = [f"cam{i:02d}" for i in range(N_STREAMS)]
    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    with tempfile.TemporaryDirectory() as tmp:
        path = record_synthetic_trace(os.path.join(tmp, "pipeline.vtrace"), streams,
                                      width=FRAME_HW[1], height=FRAME_HW[0], fps=30.0,
                                      frames=REPLAY_FRAMES)
        bus = RedisFrameBus(addr)
        try:
            zero_launches()
            t0 = time.perf_counter()
            lock = lockstep_checksum(path, model=CAMERA_MODEL, device=dev, state_dict=weights,
                                     bus=bus)
            lock_s = time.perf_counter() - t0
            lock_launches = read_launches()["nms_keep_mask"]
        finally:
            bus.close()
        by_packet: dict = {}
        for dev_id, frame, meta in TracePlayer(path).iter_frames():
            by_packet.setdefault(meta.packet, []).append((dev_id, frame, meta))
    raw = RespClient.from_addr(addr)
    raw.command("FLUSHALL")
    raw.close()
    ticks = [by_packet[n] for n in sorted(by_packet)]
    bus = RedisFrameBus(addr)
    try:
        engine = InferenceEngine(bus, EngineConfig(), device=dev, model=model)
        engine.warmup()
        zero_launches()
        t0 = time.perf_counter()
        fold = engine.serve_lockstep(ticks)
        serve_s = time.perf_counter() - t0
        serve_launches = read_launches()["nms_keep_mask"]
        frames = engine.pipeline_stats().frames
    finally:
        bus.close()
    del engine, ticks, by_packet
    n = N_STREAMS * REPLAY_FRAMES
    log(f"phase 21a replay over the Redis bus (the port's MiniRedis in a process of its own, "
        f"XADD MAXLEN ~ of {FRAME_HW[1]}x{FRAME_HW[0]} VideoFrames) on {card}: "
        f"lockstep_checksum {lock['checksum']} over {lock['frames']} frames in {lock_s:.2f} s "
        f"({lock_s * 1000.0 / max(lock['frames'], 1):.1f} ms a frame), {lock_launches} "
        f"keep-mask launches for {lock['batches']} batches; the engine's serve_lockstep {fold} "
        f"over {frames} results in {serve_s:.2f} s, {serve_launches} keep-mask launches; 11a "
        f"and 11b fold {CAMERA_FOLDS[0]} and {CAMERA_FOLDS[1]}")
    if lock["checksum"] != CAMERA_FOLDS[0] or lock["frames"] != n or lock_launches <= 0:
        raise AssertionError(f"phase 21a: the Redis bus's lockstep fold {lock} (launches "
                             f"{lock_launches}) is not 11a's {CAMERA_FOLDS[0]}")
    if fold != CAMERA_FOLDS[1] or frames != n or serve_launches <= 0:
        raise AssertionError(f"phase 21a: the engine's fold {fold} over {frames} results "
                             f"(launches {serve_launches}) is not 11b's {CAMERA_FOLDS[1]}")


def redis_server_phase(dev, card: str, model, addr: str, zero_launches, read_launches) -> None:
    """21a, second half: a ``Server`` with ``bus.backend: redis`` and
    CAMERA_REDIS_CAMS worker processes (``test://`` 1080p at 30 fps) for
    CAMERA_REDIS_S, its wire started, read by a gRPC ``Inference`` client."""
    import shutil
    import tempfile

    import grpc

    from video_edge_ai_proxy_tpu_torch.bus.resp import RespClient
    from video_edge_ai_proxy_tpu_torch.proto import video_streaming_pb2 as pb
    from video_edge_ai_proxy_tpu_torch.proto import video_streaming_pb2_grpc as pb_grpc
    from video_edge_ai_proxy_tpu_torch.serve import StreamProcess
    from video_edge_ai_proxy_tpu_torch.serve.server import Server
    from video_edge_ai_proxy_tpu_torch.utils.config import Config

    cams = [f"rcam{i:02d}" for i in range(CAMERA_REDIS_CAMS)]
    data_dir = tempfile.mkdtemp(prefix="vep_server_redis_")
    sink = AnnotationSink()
    cfg = Config()
    cfg.bus.backend = "redis"
    cfg.bus.redis_addr = addr
    cfg.annotation.endpoint = sink.url + "/api/v1/annotate"
    cfg.api.endpoint = sink.url
    cfg.worker_adoption = False        # the workers end with the server
    srv = Server(cfg, data_dir=data_dir, enable_engine=True, grpc_port=0, rest_port=0,
                 device=dev.type)
    got: dict = {}
    procs: dict = {}
    # The drain's annotation publishes, each an LPUSH round trip to Redis:
    # (monotonic end, seconds) a call.
    pub_calls: list = []
    publish = srv.annotations.publish

    def timed_publish(payload: bytes) -> bool:
        t_in = time.perf_counter()
        try:
            return publish(payload)
        finally:
            pub_calls.append((time.monotonic(), time.perf_counter() - t_in))

    srv.annotations.publish = timed_publish
    try:
        srv.settings.overwrite(EDGE_KEY, EDGE_SECRET)
        srv.engine.warmup()
        srv.engine._model.load_state_dict(model.state_dict())
        with LogCounter() as logged, \
                LaunchesAfterStart(zero_launches, read_launches, CAMERA_MODEL) as counted:
            t_boot = time.monotonic()
            srv.start()
            for name in cams:
                srv.process_manager.start(StreamProcess(name=name, rtsp_endpoint=worker_url()))
            channel = grpc.insecure_channel(f"127.0.0.1:{srv.bound_grpc_port}")
            call = pb_grpc.ImageStub(channel).Inference(pb.InferenceRequest(device_ids=cams))

            def client():
                try:
                    for r in call:
                        got.setdefault(r.device_id, []).append((time.time() * 1000.0, r))
                except grpc.RpcError:
                    pass        # cancelled at the end of the window

            reader = threading.Thread(target=client, daemon=True)
            reader.start()
            while set(srv.bus.streams()) < set(cams):
                if time.monotonic() - t_boot > 120:
                    raise AssertionError(f"phase 21a: Redis streams not up within 120 s: "
                                         f"{srv.bus.streams()}")
                time.sleep(0.1)
            up_s = time.monotonic() - t_boot
            procs = {d: srv.process_manager._entries[d].proc for d in cams}
            beats0 = heartbeats(srv.bus, cams)
            t0, t0_wall_ms = time.monotonic(), time.time() * 1000.0
            time.sleep(CAMERA_REDIS_S / 4)
            cuda_workers = [d for d, p in procs.items() if maps_cuda(p.pid)]
            apps = compute_app_pids()
            time.sleep(max(0.0, t0 + CAMERA_REDIS_S - time.monotonic()))
            wall_s = time.monotonic() - t0
            window = [(t, r) for v in list(got.values()) for t, r in list(v)
                      if t0_wall_ms <= t <= t0_wall_ms + wall_s * 1000.0]
            launches, batches = counted.launches(), counted.batches()
            beats = heartbeats(srv.bus, cams)
            call.cancel()
            channel.close()
            ann = srv.annotations
            queued = (ann.published, ann.acked, ann.dropped, ann.depth())
            raw = RespClient.from_addr(addr)
            rmq = sorted(k.decode() for k in raw.command("KEYS", "rmq::*"))
            raw.close()
        failures = {m: logged.count(m) for m in FAILURE_MESSAGES}
    finally:
        srv.stop()
        sink.close()
        shutil.rmtree(data_dir, ignore_errors=True)
    codes = {d: p.poll() for d, p in procs.items()}
    lat = sorted(t - r.timestamp for t, r in window)
    pubs = [dt for t, dt in pub_calls if t0 <= t <= t0 + wall_s]
    published = sum(beats[d].get("published", 0) - beats0[d].get("published", 0) for d in cams)
    log(f"phase 21a Server(bus.backend='redis') with {len(cams)} worker processes "
        f"({worker_url()}, XADD to MiniRedis; streams up in {up_s:.2f} s) and a gRPC Inference "
        f"client for {wall_s:.3f} s on {card}: {len(window)} results received in the window "
        f"({len(window) / wall_s:.2f} frames/s), {published} frames published by the workers "
        f"meanwhile (heartbeat deltas); capture -> client-receive "
        f"p50 {pct(lat, 50):.1f} ms, p95 {pct(lat, 95):.1f}, p99 {pct(lat, 99):.1f}; results "
        f"per camera {({d: len(v) for d, v in got.items()})}; {launches} keep-mask launches "
        f"for {batches} {CAMERA_MODEL} batches (captures of keys met in the window add "
        f"theirs); the ladder at {srv.engine.ladder.rung}; logged failures {failures}")
    log(f"phase 21a annotations through the Redis queue (published, acked, dropped, depth): "
        f"{queued}; in the window {len(pubs)} publishes from the drain took "
        f"{sum(pubs):.3f} s of its {wall_s:.3f} ({pct(sorted(pubs), 50) * 1000.0:.2f} ms each at "
        f"p50, {len(pubs) / max(len(window), 1):.1f} a result received); rmq keys {rmq}; {len(sink.posts)} signed posts at the sink; worker exit "
        f"codes at SIGTERM {codes}; workers with libcuda mapped {cuda_workers}; nvidia-smi "
        f"compute apps {apps}")
    worker_pids = {str(p.pid) for p in procs.values()}
    missing = [d for d in cams if not got.get(d)]
    if missing:
        raise AssertionError(f"phase 21a: cameras without a gRPC Inference answer: {missing}")
    if queued[0] <= 0 or not any(k.startswith("rmq::") for k in rmq):
        raise AssertionError(f"phase 21a: no annotation reached the Redis queue: {queued} {rmq}")
    if any(c != 0 for c in codes.values()):
        raise AssertionError(f"phase 21a: worker exit codes at SIGTERM {codes}")
    if cuda_workers or any(a.split(",")[0].strip() in worker_pids for a in apps):
        raise AssertionError(f"phase 21a: a worker process is on the card: {cuda_workers} {apps}")
    # Each batch launches the keep mask at least once; a key the ladder
    # first meets in the window (bucket_downshift) adds its capture's calls.
    if batches <= 0 or launches < batches or any(failures.values()):
        raise AssertionError(f"phase 21a: {launches} keep-mask launches for {batches} batches, "
                             f"failures {failures}")


def encode_clip(path: str) -> str:
    """The 21b/21c clip: CAMERA_CLIP_FRAMES frames of CAMERA_HW, a keyframe
    every CAMERA_CLIP_GOP, through the port's ``write_test_video`` with the
    first encoder of CAMERA_ENCODERS that libav offers; returns its name."""
    from video_edge_ai_proxy_tpu_torch.ingest import av

    for codec in CAMERA_ENCODERS:
        if av.encoder_available(codec):
            av.write_test_video(path, CAMERA_HW[1], CAMERA_HW[0], frames=CAMERA_CLIP_FRAMES,
                                fps=PACED_FPS, gop=CAMERA_CLIP_GOP, codec=codec)
            return codec
    raise AssertionError(f"phase 21: libav offers none of the encoders {CAMERA_ENCODERS}")


def clip_video_packets(path: str) -> list:
    """(is_keyframe, payload) of every video packet of ``path``."""
    from video_edge_ai_proxy_tpu_torch.ingest import av

    with av.PacketDemuxer(path) as d:
        out = []
        while (p := d.read(want_data=True)) is not None:
            if not p.is_audio:
                out.append((p.is_keyframe, p.data, p.pts))
        return out


def run_from_keyframe(pkts: list, source: list) -> bool:
    """``pkts``' payloads are a run of ``source``'s that starts at one of its
    keyframes."""
    payloads = [p[1] for p in source]
    if not pkts or pkts[0][1] not in payloads:
        return False
    i = payloads.index(pkts[0][1])
    return source[i][0] and payloads[i:i + len(pkts)] == [p[1] for p in pkts]


def decode_phase(dev, card: str, model, clip: str, codec: str, out_dir: str, zero_launches,
                 read_launches, beside: dict) -> None:
    """21b: CAMERA_STREAMS worker processes on the shm bus, each on the clip
    as a file endpoint (demux, lazy BGR24 decode in the worker, a re-open
    at each end of the file), read by the default engine for
    CAMERA_DECODE_S. One camera is keyframe-only."""
    import shutil

    from video_edge_ai_proxy_tpu_torch.bus import open_bus
    from video_edge_ai_proxy_tpu_torch.bus.shm_bus import ring_bytes
    from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine
    from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig

    streams = [f"clip{i:02d}" for i in range(CAMERA_STREAMS)]
    kf_cam = streams[-1]
    frame_bytes = CAMERA_HW[0] * CAMERA_HW[1] * 3
    rdir = ring_dir("b", CAMERA_STREAMS * ring_bytes(max(frame_bytes, 1920 * 1080 * 3),
                                                     WORKER_SLOTS), phase="21")
    procs: dict = {}
    try:
        bus = open_bus("shm", rdir)
        bus.set_keyframe_only(kf_cam, True)
        seen: list = []
        read_into = bus.read_latest_into

        def tracked(device_id, dst, min_seq=0):
            res = read_into(device_id, dst, min_seq)
            meta = res[1] if isinstance(res, tuple) else getattr(res, "meta", None)
            if meta is not None:
                seen.append((device_id, meta.packet, meta.is_keyframe, meta.frame_type))
            return res

        bus.read_latest_into = tracked
        engine = InferenceEngine(bus, EngineConfig(), device=dev, model=model)
        results = engine.subscribe(streams)
        got: dict = {}
        reader = threading.Thread(target=lambda: [got.setdefault(r.device_id, []).append(r)
                                                  for r in results], daemon=True)
        reader.start()
        engine.warmup()
        for d in streams:
            env = dict(worker_env(rdir, d), rtsp_endpoint=clip)
            env.pop("vep_source", None)
            with open(os.path.join(out_dir, f"worker_{d}.log"), "wb") as fh:
                procs[d] = subprocess.Popen([sys.executable, "-c", CAMERA_WORKER], cwd=ROOT,
                                            env=env, stdout=fh, stderr=subprocess.STDOUT)
        up_s = wait_for_rings(bus, procs)
        with LogCounter() as logged:
            beats0 = heartbeats(bus, streams)
            cpu0 = {d: cpu_seconds(p.pid) for d, p in procs.items()}
            zero_launches()
            engine.start()
            t0 = time.monotonic()
            try:
                time.sleep(CAMERA_DECODE_S / 4)
                apps = compute_app_pids()
                cuda_workers = [d for d, p in procs.items() if maps_cuda(p.pid)]
                time.sleep(max(0.0, t0 + CAMERA_DECODE_S - time.monotonic()))
                wall_s = time.monotonic() - t0
                cpu = {d: cpu_seconds(p.pid) - cpu0[d] for d, p in procs.items()}
                beats = heartbeats(bus, streams)
                health = engine.health()
            finally:
                engine.stop()
            launches = read_launches()["nms_keep_mask"]
            codes = stop_workers(procs)
        bus.close()
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
        shutil.rmtree(rdir, ignore_errors=True)
    reader.join(10)
    opens: dict = {}
    for d in streams:
        with open(os.path.join(out_dir, f"worker_{d}.log")) as fh:
            last = (fh.read().strip().splitlines() or ["{}"])[-1]
        try:
            for k, v in json.loads(last).items():
                opens[k] = opens.get(k, 0) + v
        except ValueError:
            opens.setdefault("unreadable", []).append(d)
    p = engine.pipeline_stats()
    lat = [r.latency_ms for v in got.values() for r in v]
    dets = [det for v in got.values() for r in v for det in r.detections]
    untracked = sum(1 for det in dets if not det.track_id)
    missing = [s for s in streams if not got.get(s)]
    delta = {d: {k: beats[d].get(k, 0) - beats0[d].get(k, 0)
                 for k in ("packets", "decoded", "keyframes", "published")} for d in streams}
    bad_kf = [(d, n, kf) for d, n, kf, _ in seen if kf != (n % CAMERA_CLIP_GOP == 0)]
    failures = {m: logged.count(m) for m in FAILURE_MESSAGES}
    log(f"phase 21b {CAMERA_STREAMS} worker processes decoding {os.path.basename(clip)} "
        f"({CAMERA_HW[1]}x{CAMERA_HW[0]}, {CAMERA_CLIP_FRAMES} frames, a keyframe every "
        f"{CAMERA_CLIP_GOP}, {codec}; a file endpoint, re-opened at its end; rings up in "
        f"{up_s:.2f} s) read by InferenceEngine(open_bus('shm'), EngineConfig()) for "
        f"{wall_s:.3f} s on {card}: {p.frames} results ({p.frames / wall_s:.2f} frames/s), "
        f"{p.batches} batches; capture->result p50 {pct(lat, 50):.3f} ms, p95 "
        f"{pct(lat, 95):.3f}, p99 {pct(lat, 99):.3f}; beside 13b's pattern render in this "
        f"run: {beside or 'not run in this process'}")
    log("phase 21b workers (packets/decoded/keyframes/published over the window; host cores; "
        "CPU ms a decoded frame, demux, decode and publish): "
        + ", ".join(f"{d} {v['packets']}/{v['decoded']}/{v['keyframes']}/{v['published']} "
                    f"{cpu[d] / wall_s:.3f} {cpu[d] * 1000.0 / max(v['decoded'], 1):.2f}"
                    for d, v in delta.items()))
    log(f"phase 21b checks: vep_source_opens_total in the workers {opens}; frames read by the "
        f"engine {len(seen)}, is_keyframe off the every-{CAMERA_CLIP_GOP} cadence {bad_kf[:5]}; "
        f"keyframe-only camera {kf_cam}: {delta[kf_cam]}; {len(dets)} detections, {untracked} "
        f"without a track id; logged failures {failures}; keep-mask launches {launches}; "
        f"worker exit codes at SIGTERM {sorted(set(map(str, codes.values())))}; workers with "
        f"libcuda mapped {cuda_workers}; health ok {health['ok']}")
    worker_pids = {str(pr.pid) for pr in procs.values()}
    if opens.get("packet") != CAMERA_STREAMS or opens.get("opencv") or opens.get("unreadable"):
        raise AssertionError(f"phase 21b: vep_source_opens_total {opens}: every worker must "
                             f"open its file through the libav shim")
    if missing:
        raise AssertionError(f"phase 21b: streams without results: {missing}")
    if not seen or bad_kf:
        raise AssertionError(f"phase 21b: is_keyframe off the clip's cadence: {bad_kf[:10]}")
    kf = delta[kf_cam]
    if not (0 < kf["decoded"] == kf["keyframes"]) or any(
            v["decoded"] <= v["keyframes"] for d, v in delta.items() if d != kf_cam):
        raise AssertionError(f"phase 21b: keyframe-only decode: {delta}")
    if not dets or untracked:
        raise AssertionError(f"phase 21b: {untracked} of {len(dets)} detections without a "
                             f"track id")
    if any(c != 0 for c in codes.values()):
        raise AssertionError(f"phase 21b: worker exit codes at SIGTERM {codes}")
    if cuda_workers or any(a.split(",")[0].strip() in worker_pids for a in apps):
        raise AssertionError(f"phase 21b: a worker process is on the card: {cuda_workers} {apps}")
    if launches <= 0 or any(failures.values()) or not health["ok"]:
        raise AssertionError(f"phase 21b: keep-mask launches {launches}, failures {failures}, "
                             f"health {health}")


def side_paths_phase(card: str, clip: str, out_dir: str) -> None:
    """21c: the archive (a worker process with ``disk_buffer_path``, the
    clip once through) and the RTMP pass-through to an ``.flv`` file (a
    worker on the shm bus whose ``proxy_rtmp`` turns on at grab
    CAMERA_RELAY_TOGGLE, mid-GOP)."""
    import shutil
    import tempfile

    from video_edge_ai_proxy_tpu_torch.bus import open_bus
    from video_edge_ai_proxy_tpu_torch.ingest.sources import PacketSource
    from video_edge_ai_proxy_tpu_torch.ingest.worker import IngestWorker, WorkerConfig

    source = clip_video_packets(clip)
    work = tempfile.mkdtemp(prefix="vep_side_")
    try:
        arch = os.path.join(work, "archive")
        env = dict(worker_env(os.path.join(work, "rings"), "arch"), rtsp_endpoint=clip,
                   disk_buffer_path=arch, vep_max_frames=str(CAMERA_CLIP_FRAMES))
        env.pop("vep_source", None)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "video_edge_ai_proxy_tpu_torch.ingest.worker"],
                              cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        with open(os.path.join(out_dir, "worker_arch.log"), "w") as fh:
            fh.write(proc.stdout + proc.stderr)
        arch_s = time.perf_counter() - t0
        segs = sorted(os.listdir(os.path.join(arch, "arch"))) if os.path.isdir(
            os.path.join(arch, "arch")) else []
        seg_pkts = [clip_video_packets(os.path.join(arch, "arch", s)) for s in segs]
        archived = sorted(p[1] for pk in seg_pkts for p in pk)
        bad_heads = [s for s, pk in zip(segs, seg_pkts)
                     if not (pk and pk[0][0] and pk[0][2] == 0 and run_from_keyframe(pk, source))]
        log(f"phase 21c archive on {card}: a worker process (disk_buffer_path, "
            f"vep_max_frames={CAMERA_CLIP_FRAMES}) exited {proc.returncode} in {arch_s:.2f} s; "
            f"{len(segs)} MP4 segments {segs}, {len(archived)} video packets archived of "
            f"{len(source)} fed; segments without a keyframe head at pts 0 or off the clip's "
            f"packets {bad_heads}")
        if proc.returncode != 0 or len(segs) != CAMERA_CLIP_FRAMES // CAMERA_CLIP_GOP or \
                bad_heads or archived != sorted(p[1] for p in source):
            raise AssertionError(f"phase 21c: the archive: exit {proc.returncode}, segments "
                                 f"{segs}, bad heads {bad_heads}")

        relay = os.path.join(work, "relay.flv")
        bus = open_bus("shm", os.path.join(work, "relay_rings"))
        try:
            worker = IngestWorker(WorkerConfig(rtsp_endpoint=clip, device_id="relay",
                                               rtmp_endpoint=relay,
                                               max_frames=CAMERA_CLIP_FRAMES),
                                  bus=bus, source=PacketSource(clip))
            grab, count = worker.source.grab, [0]

            def counting_grab():
                count[0] += 1
                if count[0] == CAMERA_RELAY_TOGGLE:
                    bus.set_proxy_rtmp("relay", True)      # the Proxy RPC's write
                return grab()

            worker.source.grab = counting_grab
            worker.run()
        finally:
            bus.close()
        relayed = clip_video_packets(relay)
        first = (CAMERA_RELAY_TOGGLE - 1) // CAMERA_CLIP_GOP * CAMERA_CLIP_GOP
        log(f"phase 21c relay on {card}: proxy_rtmp on at packet {CAMERA_RELAY_TOGGLE - 1} "
            f"(mid-GOP): {len(relayed)} video packets in {os.path.basename(relay)}, the first a "
            f"keyframe {bool(relayed and relayed[0][0])}, equal to the clip's packets "
            f"{first}-{len(source) - 1} {[p[1] for p in relayed] == [p[1] for p in source[first:]]}; "
            f"decode gate kept lazy: decoded {worker._decoded} of {worker._packets} packets")
        if [p[1] for p in relayed] != [p[1] for p in source[first:]] or not relayed[0][0]:
            raise AssertionError(f"phase 21c: the relay holds {len(relayed)} packets, not the "
                                 f"clip's {first}-{len(source) - 1} from the activating keyframe")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def camera_phase(dev, card: str, zero_launches, read_launches, report: dict) -> None:
    """Phase 21: the camera tier. (a) the Redis wire: 11a's trace over a
    RedisFrameBus on the port's MiniRedis, then a Server with
    ``bus.backend: redis``; (b) real decode of an encoded clip by 16 worker
    processes; (c) the archive and the RTMP pass-through. (b) and (c) need
    the FFmpeg development files, and run only where ``g++`` finds them."""
    import shutil
    import tempfile

    import torch

    found, line = libav_probe()
    log(line)
    beside = json.loads(sys.argv[2]) if len(sys.argv) > 2 else {}
    out_dir = os.path.join(ROOT, "chiprun_out", "phase21")
    os.makedirs(out_dir, exist_ok=True)
    model = seeded_detector(dev)
    t0 = time.perf_counter()
    redis_proc, addr = start_miniredis()
    try:
        redis_replay_phase(dev, card, model, addr, zero_launches, read_launches)
        redis_server_phase(dev, card, model, addr, zero_launches, read_launches)
    finally:
        redis_proc.terminate()
        redis_proc.wait(30)
    log(f"phase 21a took {time.perf_counter() - t0:.1f} s")
    if not found:
        return
    from video_edge_ai_proxy_tpu_torch.ingest import av

    t0 = time.perf_counter()
    av._load()                 # built once here, before any worker starts
    build_s = time.perf_counter() - t0
    work = tempfile.mkdtemp(prefix="vep_clip_")
    try:
        clip = os.path.join(work, "clip.mp4")
        t0 = time.perf_counter()
        codec = encode_clip(clip)
        source = clip_video_packets(clip)
        log(f"phase 21b the libav shim built in {build_s:.2f} s; the clip encoded with {codec} "
            f"in {time.perf_counter() - t0:.2f} s: {len(source)} packets, keyframes at "
            f"{[i for i, p in enumerate(source) if p[0]]}")
        t0 = time.perf_counter()
        decode_phase(dev, card, model, clip, codec, out_dir, zero_launches, read_launches,
                     beside)
        log(f"phase 21b took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        side_paths_phase(card, clip, out_dir)
        log(f"phase 21c took {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    del model
    torch.cuda.empty_cache()


# -- phase 23: the self-training loop ----------------------------------------------------------

# SELFTRAIN_r05.json's recipe. Phase 23 runs in a process of its own.
SELFTRAIN = dict(model_name="yolov8n", batch_size=8, n_cameras=2, segments_per_camera=6,
                 frames_per_segment=24, learning_rate=3e-3, val_images=120, seed=0)
# SELFTRAIN_r05.json took 600 steps; 300 keep the whole script inside its
# time limit (600 took 103 s of training and phases 1-23 1101.6 s).
SELFTRAIN_STEPS = 300
# SELFTRAIN_r05.json's post mAP50: a TPU v5 lite record with other random
# draws, printed beside the card's figure and never gated on.
SELFTRAIN_TPU_POST_MAP50 = 0.7026097272026282
SELFTRAIN_LOSS_ITERS = 20            # detection-loss timing: CUDA-event iterations
SELFTRAIN_CHILD_TIMEOUT_S = 600


class LegLaunches:
    """``leg(name)`` for ``torch_selftrain_e2e.run``: each serving leg's
    keep-mask launches, counted from its start (an engine leg's from its
    ``start()``, after the prewarm, as ``LaunchesAfterStart`` counts)."""

    def __init__(self, zero_launches, read_launches, model: str):
        self._zero, self._read, self._model = zero_launches, read_launches, model
        self.launches: dict = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        with LaunchesAfterStart(self._zero, self._read, self._model) as counted:
            self._zero()
            yield
            self.launches[name] = counted.launches()


def step_breakdown(dev, card: str, ckpt: str, batch_size: int) -> dict:
    """Where a train step's time goes, at the loop's shapes (the tuned
    model, one synthetic batch of ``batch_size`` 640² images with 8 padded
    targets): the step's wall ms and CUDA-event ms (medians of 20), the
    device's busy ms a step by torch.profiler over 5 steps (table in
    ``chiprun_out/chip_smoke_profile_selftrain.txt``), and the detection
    loss's forward + backward and the assigner's ms by CUDA events over
    ``SELFTRAIN_LOSS_ITERS`` calls on the head's outputs of that batch."""
    import numpy as np
    import torch

    from video_edge_ai_proxy_tpu_torch.models import detect_loss, registry
    from video_edge_ai_proxy_tpu_torch.parallel import make_trainer
    from video_edge_ai_proxy_tpu_torch.utils.checkpoint import load_msgpack

    spec = registry.get(SELFTRAIN["model_name"])
    model = spec.init_params(device=dev, param_dtype=torch.float32)
    trainer = make_trainer(model, dev, learning_rate=SELFTRAIN["learning_rate"], clip_norm=10.0,
                           mutable_aux=True,
                           loss_fn=detect_loss.make_detection_loss_fn(model.cfg, True))
    state = trainer.init_state_from(load_msgpack(ckpt))
    s = spec.input_size
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(0, 1, (batch_size, 3, s, s)).astype(np.float32)).to(dev)
    xy = rng.uniform(0, s * 0.6, (batch_size, 8, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(s / 8, s / 3, (batch_size, 8, 2))], -1)
    t = {"boxes": torch.from_numpy(boxes.astype(np.float32)).to(dev),
         "labels": torch.from_numpy(rng.integers(0, 3, (batch_size, 8))).to(dev),
         "mask": torch.from_numpy(rng.uniform(size=(batch_size, 8)) < 0.5).to(dev)}

    def step():
        trainer.train_step(state, x, t)

    out = dict(zip(("step_wall_ms", "step_event_ms"), median_call_ms(step)))
    out["busy_ms"] = profile_step(step, 5, card, "yolov8n train step (batch 8, 640^2)",
                                  "chip_smoke_profile_selftrain.txt", "phase 23")
    with torch.no_grad():
        head = [(b.float(), c.float()) for b, c in model(x, decode=False)]
    leaves = [(b.clone().requires_grad_(), c.clone().requires_grad_()) for b, c in head]
    box_l, cls_l, anchors, strides = detect_loss.flatten_levels(head, model.cfg)
    pred = detect_loss._decode_dfl(box_l, anchors, strides, model.cfg.reg_max)
    out["loss_ms"] = time_events(
        lambda: detect_loss.detection_loss(leaves, t, model.cfg).backward(),
        SELFTRAIN_LOSS_ITERS)
    out["assign_ms"] = time_events(
        lambda: detect_loss.assign(cls_l, pred, anchors, t["boxes"], t["labels"], t["mask"]),
        SELFTRAIN_LOSS_ITERS)
    del model, trainer, state, leaves
    torch.cuda.empty_cache()
    return out


def replay_after_reload(dev, ckpt: str, work: str) -> str:
    """A checkpoint ``save_checkpoint`` writes reloads into a fresh engine
    whose graphed step gives bit-identical outputs on one batch of 8."""
    import numpy as np
    import torch

    from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
    from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine
    from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig

    name = SELFTRAIN["model_name"]
    s = 640
    frames = torch.from_numpy(np.random.default_rng(11).integers(
        0, 256, (8, s, s, 3), np.uint8)).to(dev)
    outs, saved = [], os.path.join(work, "saved.msgpack")
    for path in (ckpt, saved):
        engine = InferenceEngine(MemoryFrameBus(), EngineConfig(model=name, checkpoint_path=path),
                                 device=dev)
        engine.warmup()
        with torch.inference_mode(), engine._compute_stream():
            step = engine._step((s, s), 8)
            outs.append({k: v.clone() for k, v in step(frames).items()})
            torch.cuda.synchronize()
        if path == ckpt:
            engine.save_checkpoint(saved)
        del engine, step
    same = all(torch.equal(outs[0][k], outs[1][k]) for k in outs[0])
    if not same:
        raise AssertionError("phase 23: the reloaded checkpoint's graphed step differs")
    torch.cuda.empty_cache()
    return f"bit-identical over {sorted(outs[0])}, {int(outs[0]['valid'].sum())} detections"


def selftrain_phase(dev, card: str, zero_launches, read_launches, report: dict) -> None:
    """Phase 23: the self-training loop (module docstring)."""
    import importlib.util
    import shutil
    import tempfile

    have = {m: importlib.util.find_spec(m) is not None for m in ("cv2", "msgpack")}
    log(f"phase 23 the self-training loop on {card}: cv2 imports: {have['cv2']} (mp4 "
        f"segments {'through cv2' if have['cv2'] else 'absent: the archiver writes .npz'}); "
        f"msgpack imports: {have['msgpack']} (the port reads and writes its checkpoints "
        f"itself)")
    st = tool_module("torch_selftrain_e2e")
    work = tempfile.mkdtemp(prefix="selftrain_")
    legs = LegLaunches(zero_launches, read_launches, SELFTRAIN["model_name"])
    try:
        t0 = time.perf_counter()
        with LogCounter(level=20) as lines:
            rec = st.run(steps=SELFTRAIN_STEPS, workdir=work, device="cuda", leg=legs,
                         log=lambda m: None, **SELFTRAIN)
        wall = time.perf_counter() - t0
        where = step_breakdown(dev, card, rec["checkpoint"], SELFTRAIN["batch_size"])
        replay = replay_after_reload(dev, rec["checkpoint"], work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    cal = rec["calibration"]
    batches = {"eval_pre": rec["eval_batches"]["pre"], "eval_post": rec["eval_batches"]["post"],
               "calibrate": rec["eval_batches"]["calibrate"],
               "engine_pre": rec["engine_pre"]["batches"],
               "engine_post": rec["engine_post"]["batches"]}
    applied = [r.getMessage() for r in lines.records
               if r.getMessage().startswith("serving at calibrated conf_threshold")]
    want_line = f"serving at calibrated conf_threshold={cal['conf_threshold']:.3f}"
    log(f"phase 23 {rec['model']} at {rec['source_hw']}, {rec['train_frames']} archived frames "
        f"in {rec['archived_segments']} segments, batch {rec['batch_size']}, lr "
        f"{rec['learning_rate']}, {rec['steps']} steps ({wall:.1f} s in all): loss "
        f"{rec['first_loss']:.4f} -> {rec['last_loss']:.4f}; train {rec['train_s']} s, "
        f"{rec['step_ms_p50']:.2f} ms a step at p50 (host clock, each step read back); peak "
        f"reserved {(rec['peak_reserved_bytes'] or 0) / 2**30:.2f} GiB; one step on a fixed "
        f"batch {where['step_wall_ms']:.2f} ms wall, {where['step_event_ms']:.2f} ms between "
        f"CUDA events, the device busy {where['busy_ms']:.2f} ms of it (idle "
        f"{100 * (1 - where['busy_ms'] / where['step_wall_ms']):.1f}%); detection loss forward "
        f"+ backward {where['loss_ms']:.3f} ms, the assigner {where['assign_ms']:.3f} ms (CUDA "
        f"events)")
    log(f"phase 23 held-out mAP over {rec['val_images']} images: pre {rec['pre']}, post "
        f"{rec['post']} (SELFTRAIN_r05.json: post mAP50 {SELFTRAIN_TPU_POST_MAP50:.4f} after 600 "
        f"steps on a TPU with other random draws, not gated); calibrated point {cal}")
    log(f"phase 23 engine serve-back: pre {rec['engine_pre']}, post {rec['engine_post']}; "
        f"threshold log lines {applied}; keep-mask launches by leg {legs.launches} for "
        f"batches {batches}; save -> reload -> replay: {replay}")
    finite = all(map(math.isfinite, (rec["first_loss"], rec["last_loss"])))
    failed = [g for g, ok in (
        ("finite falling loss", finite and rec["last_loss"] < rec["first_loss"]),
        ("post mAP50 > pre", rec["post"]["mAP50"] > rec["pre"]["mAP50"]),
        ("every held-out image served",
         rec["engine_pre"]["images_served"] == rec["engine_post"]["images_served"]
         == rec["val_images"]),
        ("the checkpoint's threshold applied",
         rec["engine_post"]["conf_threshold"] == cal["conf_threshold"]
         and rec["engine_pre"]["conf_threshold"] == 0.0
         and any(m.startswith(want_line) for m in applied)),
        ("keep-mask launches == batches",
         legs.launches == batches and all(v > 0 for v in batches.values())),
    ) if not ok]
    if failed:
        raise AssertionError(f"phase 23: failed {failed}")
    report["launches_selftrain"] = sum(legs.launches.values())


def child_main(phase) -> int:
    """``chip_smoke.py --soak`` / ``--e2e`` / ``--camera`` / ``--fleet-tier`` /
    ``--selftrain``: phase 19, 20, 21, 22 or 23 alone, as ``main`` runs it in a process of its own (the kernels as phase 2 built them);
    the keep mask's report entries are its last line."""
    import torch

    if not torch.cuda.is_available():
        return 1
    sys.path.insert(0, ROOT)
    from video_edge_ai_proxy_tpu_torch.device import resolve_device
    from video_edge_ai_proxy_tpu_torch.kernels import build
    from video_edge_ai_proxy_tpu_torch.kernels.nms import nms_keep_mask_cuda

    build.build_all()

    def zero_launches():
        nms_keep_mask_cuda.launches = 0

    def read_launches():
        return {"nms_keep_mask": nms_keep_mask_cuda.launches}

    report: dict = {}
    phase(resolve_device("cuda"), card_line(), zero_launches, read_launches, report)
    print(json.dumps(report), flush=True)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from video_edge_ai_proxy_tpu_torch.bus.interface import FrameMeta
    from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
    from video_edge_ai_proxy_tpu_torch.device import resolve_device
    from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine, build_serving_step
    from video_edge_ai_proxy_tpu_torch.kernels import build
    from video_edge_ai_proxy_tpu_torch.kernels.flash import (
        flash_attention_bwd_dkv_cuda, flash_attention_bwd_dq_cuda, flash_attention_fwd_cuda,
    )
    from video_edge_ai_proxy_tpu_torch.kernels.nms import launch_config as nms_launch_config
    from video_edge_ai_proxy_tpu_torch.kernels.nms import nms_keep_mask_cuda
    from video_edge_ai_proxy_tpu_torch.models import registry
    from video_edge_ai_proxy_tpu_torch.models.carry import zero_class_prior
    from video_edge_ai_proxy_tpu_torch.ops.flash_attention import (
        _pack, flash_attention_reference, packed_len,
    )
    from video_edge_ai_proxy_tpu_torch.ops.nms import nms_keep_mask, nms_keep_mask_reference
    from video_edge_ai_proxy_tpu_torch.ops.preprocess import (
        frame_quality_stats, preprocess_classify, preprocess_clip, preprocess_letterbox,
    )
    from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig

    # Every kernel: its wrapper (which counts launches), the main path it
    # serves, and where it comes from.
    kernels = {
        "nms_keep_mask": {
            "route": "cuda",
            "source": "video_edge_ai_proxy_tpu_torch/" + build.SOURCES["nms_keep_mask"],
            "replaces": "video_edge_ai_proxy_tpu/ops/nms.py:68",
            "wrapper": nms_keep_mask_cuda,
            "path": "detect",
        },
        "flash_attention_fwd": {
            "route": "cuda",
            # bf16 (the main path) on the tensor cores; float32 on the CUDA cores.
            "source": "video_edge_ai_proxy_tpu_torch/" + build.SOURCES["flash_attention_fwd_sm90"],
            "source_f32": "video_edge_ai_proxy_tpu_torch/" + build.SOURCES["flash_attention_fwd"],
            "replaces": "video_edge_ai_proxy_tpu/ops/flash_attention.py:48",
            "wrapper": flash_attention_fwd_cuda,
            "path": "video",
        },
        "flash_attention_bwd_dq": {
            "route": "cuda",
            # bf16 (the main path) on the tensor cores; float32 on the CUDA cores.
            "source": "video_edge_ai_proxy_tpu_torch/"
                      + build.SOURCES["flash_attention_bwd_dq_sm90"],
            "source_f32": "video_edge_ai_proxy_tpu_torch/" + build.SOURCES["flash_attention_bwd"],
            "replaces": "video_edge_ai_proxy_tpu/ops/flash_attention.py:114",
            "wrapper": flash_attention_bwd_dq_cuda,
            "path": "train",
        },
        "flash_attention_bwd_dkv": {
            "route": "cuda",
            # bf16 (the main path) on the tensor cores; float32 on the CUDA cores.
            "source": "video_edge_ai_proxy_tpu_torch/"
                      + build.SOURCES["flash_attention_bwd_dkv_sm90"],
            "source_f32": "video_edge_ai_proxy_tpu_torch/" + build.SOURCES["flash_attention_bwd"],
            "replaces": "video_edge_ai_proxy_tpu/ops/flash_attention.py:148",
            "wrapper": flash_attention_bwd_dkv_cuda,
            "path": "train",
        },
    }
    report = {name: {} for name in kernels}

    def zero_launches():
        for spec_k in kernels.values():
            spec_k["wrapper"].launches = 0

    def read_launches():
        return {n: kernels[n]["wrapper"].launches for n in kernels}

    # -- phase 1: the card ------------------------------------------------
    t_script = time.perf_counter()
    dev = resolve_device("cuda")
    card = card_line()
    log(card)
    log(f"phase 1 card: {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    # -- phase 2: build ---------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"phase 2 build: {len(build.SOURCES)} source(s) for {len(kernels)} kernel(s), "
        f"{len(logs)} built now, in {time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        log(f"phase 2 {name}: " + "; ".join(ptxas_summary(text)))
    for sm90 in ("flash_attention_fwd_sm90", "flash_attention_bwd_dq_sm90",
                 "flash_attention_bwd_dkv_sm90"):
        spills = [e for e in ptxas_summary(logs.get(sm90, "")) if "spilled" in e
                  and "0/0 B spilled" not in e]
        hgmma = sass_hgmma_counts(build.library_path(sm90))
        log(f"phase 2 {sm90} SASS: HGMMA instructions per kernel "
            + ", ".join(f"{n} {c}" for n, c in hgmma.items()))
        if not hgmma or min(hgmma.values()) == 0 or spills:
            raise AssertionError(f"the tensor-core library {sm90} lacks HGMMA instructions in "
                                 f"a kernel ({hgmma}) or spills ({spills})")
    nms_spills = [e for e in ptxas_summary(logs.get("nms_keep_mask", ""))
                  if "spilled" in e and "0/0 B spilled" not in e]
    nms_cfg = {k: nms_launch_config(k) for k in (256, 1024)}
    log(f"phase 2 nms_keep_mask launch: a cluster of {nms_cfg[256]['cluster']} CTAs per "
        f"image, {nms_cfg[256]['smem_bytes']} B of dynamic shared memory per CTA at K = 256, "
        f"{nms_cfg[1024]['smem_bytes']} B at K = 1024 (registers and spills above)")
    if nms_spills:
        raise AssertionError(f"the keep-mask kernel spills: {nms_spills}")

    # -- phase 3: each kernel against its plain version ---------------------
    gen = torch.Generator().manual_seed(0)
    worst = 0
    for b, k in ((16, 256), (4, 1024), (2, 100)):
        boxes = nms_boxes(gen, b, k, dev)
        got = nms_keep_mask_cuda(boxes, 0.45)
        torch.cuda.synchronize()
        want = nms_keep_mask_reference(boxes, 0.45)
        err = int((got.int() - want.int()).abs().max())
        worst = max(worst, err)
        if not torch.equal(got, want):
            raise AssertionError(f"keep-mask kernel differs from its plain version at "
                                 f"B={b} K={k}: {int((got != want).sum())} of {got.numel()}")
        log(f"phase 3 nms_keep_mask B={b} K={k}: bit-identical to the plain version "
            f"(kept {int(got.sum())} of {got.numel()})")
    for b, k in NMS_EDGE_SHAPES:
        kept = []
        for nonfinite in (False, True):
            boxes = nms_boxes(gen, b, k, dev, nonfinite=nonfinite)
            for t in NMS_EDGE_THRESHOLDS:
                got = nms_keep_mask_cuda(boxes, t)
                torch.cuda.synchronize()
                want = nms_keep_mask_reference(boxes, t)
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"keep-mask kernel differs from its plain version at B={b} K={k} "
                        f"t={t} nonfinite={nonfinite}: {int((got != want).sum())} of "
                        f"{got.numel()}")
                kept.append(int(got.sum()))
        log(f"phase 3 nms_keep_mask B={b} K={k}: bit-identical to the plain version at "
            f"t = {', '.join(map(str, NMS_EDGE_THRESHOLDS))}, finite boxes and boxes with "
            f"NaN and infinite coordinates (kept {kept} of {b * k} each)")
    for b, k in ((1, 33), (16, 256), (4, 1024)):
        boxes = nms_chain_boxes(b, k, dev)
        got = nms_keep_mask_cuda(boxes, 0.45)
        torch.cuda.synchronize()
        want = nms_keep_mask_reference(boxes, 0.45)
        if not (torch.equal(got, want) and bool(want[:, 0::2].all())
                and not bool(want[:, 1::2].any())):
            raise AssertionError(f"keep-mask kernel or plain version wrong on a suppression "
                                 f"chain at B={b} K={k}: {int((got != want).sum())} differ")
        log(f"phase 3 nms_keep_mask B={b} K={k} suppression chain: every other box kept, "
            f"bit-identical to the plain version")

    # The flash forward and backward: videomae_b_long's shape (BH = 2 clips
    # x 12 heads, T = 6272, D = 64), a padded T = 200 (true_t < Tp), and the
    # tiny twins' head dims 16 and 32, in float32 and bf16. At T = 200 the
    # profiler also names the kernel each dtype's forward, dq and dk/dv calls
    # ran.
    flash_worst = 0.0
    bwd_worst = {"dq": 0.0, "dkv": 0.0}
    qgen = torch.Generator(device=dev).manual_seed(2)
    for bh, t, d, dtype in ((24, 6272, 64, torch.float32), (24, 6272, 64, torch.bfloat16),
                            (24, 200, 64, torch.float32), (24, 200, 64, torch.bfloat16),
                            (8, 200, 16, torch.float32), (8, 6272, 32, torch.bfloat16),
                            (8, 1568, 16, torch.bfloat16)):
        tp = packed_len(t)
        q, k, v = (torch.randn((bh, t, d), generator=qgen, device=dev).to(dtype)
                   for _ in range(3))
        q, k, v = (torch.nn.functional.pad(x, (0, 0, 0, tp - t)) for x in (q, k, v))
        f_err, o_err, lse_err = check_flash(q, k, v, t)
        flash_worst = max(flash_worst, f_err)
        log(f"phase 3 flash_attention_fwd BH={bh} T={t} (Tp={tp}) D={d} {dtype}: "
            f"max|dO| {o_err:.3g}, max|dLSE| {lse_err:.3g} against the plain version")
        bwd_args = (q, k, v, *bwd_inputs(q, k, v, t, qgen), t)
        errs = check_flash_bwd(*bwd_args)
        if t == 200 and d == 64:
            tensor_core = dtype == torch.bfloat16
            for name, call, part in (
                    ("flash_attention_fwd", lambda: flash_attention_fwd_cuda(q, k, v, t),
                     "flash_fwd_kernel"),
                    ("flash_attention_bwd_dq", lambda: flash_attention_bwd_dq_cuda(*bwd_args),
                     "flash_bwd_dq_kernel"),
                    ("flash_attention_bwd_dkv", lambda: flash_attention_bwd_dkv_cuda(*bwd_args),
                     "flash_bwd_dkv_kernel")):
                names = [n for n in launched_kernels(call) if part in n]
                if len(names) != 1 or (part + "_wgmma" in names[0]) != tensor_core:
                    raise AssertionError(f"a {dtype} {name} call ran {names}, expected the "
                                         f"{'tensor-core' if tensor_core else 'float32'} kernel")
                log(f"phase 3 {name} {dtype} ran {names[0][:80]}")
        for name, err in errs.items():
            bwd_worst[name] = max(bwd_worst[name], err)
        log(f"phase 3 flash_attention_bwd BH={bh} T={t} (Tp={tp}) D={d} {dtype}: "
            f"max|d dq| {errs['dq']:.3g}, max|d dk, dv| {errs['dkv']:.3g} against the "
            f"plain versions")
        del q, k, v, bwd_args
    torch.cuda.empty_cache()

    # -- phase 4: the slice at full width -------------------------------------
    spec = registry.get("yolov8n")
    model = spec.init_params(torch.Generator().manual_seed(0), device=dev)
    model.load_state_dict(zero_class_prior(model.state_dict()))
    fgen = torch.Generator(device=dev).manual_seed(1)
    frames = torch.randint(0, 256, (N_STREAMS,) + FRAME_HW + (3,), generator=fgen,
                           dtype=torch.uint8, device=dev)
    captured = []

    def recording_keep_mask(boxes, t):
        captured.append((boxes.clone(), t))
        return nms_keep_mask(boxes, t)

    step = build_serving_step(model, spec, quality_thumb=THUMB)
    for _ in range(3):
        step(frames)
    torch.cuda.synchronize()
    for spec_k in kernels.values():
        spec_k["wrapper"].launches = 0
    out = step(frames)
    torch.cuda.synchronize()
    step_launches = {n: kernels[n]["wrapper"].launches for n in kernels}
    if step_launches["nms_keep_mask"] != 1:
        raise AssertionError(f"one serving step launched the keep-mask kernel "
                             f"{step_launches['nms_keep_mask']} times, expected 1")
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    want_shapes = {"boxes": (16, 100, 4), "scores": (16, 100), "classes": (16, 100),
                   "valid": (16, 100), "quality_stats": (16, 3),
                   "quality_thumbs": (16, THUMB, THUMB)}
    if shapes != want_shapes:
        raise AssertionError(f"output shapes {shapes} != {want_shapes}")
    for key in ("boxes", "scores", "quality_stats", "quality_thumbs"):
        if not bool(torch.isfinite(out[key]).all()):
            raise AssertionError(f"non-finite values in {key}")
    n_valid = int(out["valid"].sum())
    if n_valid <= 0:
        raise AssertionError("no detections: NMS did no work")
    log(f"phase 4 step: shapes ok, finite, {n_valid} detections over {N_STREAMS} frames, "
        f"keep-mask launches per step = {step_launches['nms_keep_mask']}")

    ref_step = build_serving_step(model, spec, quality_thumb=THUMB,
                                  keep_mask=nms_keep_mask_reference)
    ref = ref_step(frames)
    for key in ("boxes", "scores", "classes", "valid"):
        if not torch.equal(out[key], ref[key]):
            raise AssertionError(f"step with the kernel differs from the step with the "
                                 f"plain keep mask in {key}")
    log("phase 4 step with the plain keep mask swapped in: identical detections")

    # float32 on the card (TF32 off) against float32 on the CPU, full width,
    # on two frames: preprocessing, the raw head outputs of every level
    # (box DFL logits and class logits) and the decoded boxes. Tolerances:
    # the two run the same function through different convolution
    # algorithms, so sums differ in order; 1e-3 on logits and 1e-2 px on
    # boxes in a 640-px frame are far above that noise and far below any
    # real difference. (Class ids are not compared: with random weights the
    # top two class logits of an anchor are often closer than the noise.)
    m32 = spec.init_params(torch.Generator().manual_seed(0), device=dev, dtype=torch.float32)
    m32_cpu = spec.init_params(torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
    two = frames[:2]
    with torch.inference_mode():
        x_gpu, _ = preprocess_letterbox(two, 640, out_dtype=torch.float32)
        x_cpu, _ = preprocess_letterbox(two.cpu(), 640, out_dtype=torch.float32)
        pre_err = float((x_gpu.cpu() - x_cpu).abs().max())
        head_gpu = m32(x_gpu.permute(0, 3, 1, 2), decode=False)
        head_cpu = m32_cpu(x_cpu.permute(0, 3, 1, 2), decode=False)
        logit_err = max(float((g.cpu() - c).abs().max())
                        for lg, lc in zip(head_gpu, head_cpu) for g, c in zip(lg, lc))
        b_gpu, _ = m32(x_gpu.permute(0, 3, 1, 2), decode=True)
        b_cpu, _ = m32_cpu(x_cpu.permute(0, 3, 1, 2), decode=True)
        s_gpu, _ = frame_quality_stats(two, torch.zeros((2, THUMB, THUMB), device=dev),
                                       (THUMB, THUMB))
        s_cpu, _ = frame_quality_stats(two.cpu(), torch.zeros((2, THUMB, THUMB)),
                                       (THUMB, THUMB))
    box_err = float((b_gpu.cpu() - b_cpu).abs().max())
    stat_err = float((s_gpu.cpu() - s_cpu).abs().max())
    log(f"phase 4 f32 card vs CPU (yolov8n, 2 frames): preprocess {pre_err:.3g}, "
        f"head logits {logit_err:.3g}, boxes {box_err:.3g} px, quality stats {stat_err:.3g}")
    if not (pre_err <= 1e-4 and logit_err <= 1e-3 and box_err <= 1e-2 and stat_err <= 1e-4):
        raise AssertionError("float32 on the card disagrees with float32 on the CPU")
    del m32, m32_cpu

    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(5):
        step(frames)
    torch.cuda.synchronize()
    for _ in range(20):
        t0 = time.perf_counter()
        step(frames)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1000.0)
    step_ms = statistics.median(times)
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2**20
    log(f"phase 4 timing on {card}: yolov8n bf16 640, batch {N_STREAMS}x1080x1920 uint8: "
        f"median {step_ms:.3f} ms/batch over 20 (min {min(times):.3f}, max {max(times):.3f}), "
        f"{N_STREAMS * 1000.0 / step_ms:.1f} frames/s, peak memory {peak_mib:.1f} MiB")

    # The kernel's own time, on the candidates the main path gave it.
    cap_step = build_serving_step(model, spec, quality_thumb=THUMB,
                                  keep_mask=recording_keep_mask)
    cap_step(frames)
    cand, thresh = captured[-1]
    got = nms_keep_mask_cuda(cand, thresh)
    want = nms_keep_mask_reference(cand, thresh)
    worst = max(worst, int((got.int() - want.int()).abs().max()))
    if not torch.equal(got, want):
        raise AssertionError("keep-mask kernel differs from its plain version on the "
                             "main path's candidates")
    b_, k_ = cand.shape[0], cand.shape[1]
    ev_ms = time_events(lambda: nms_keep_mask_cuda(cand, thresh), 200)
    prof_ms = profiled_device_ms(lambda: nms_keep_mask_cuda(cand, thresh), 50,
                                 "nms_keep_mask")
    plain_ms = time_events(lambda: nms_keep_mask_reference(cand, thresh), 10)
    bound_bytes_ms = (b_ * k_ * 16 + b_ * k_) / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = b_ * (k_ * (k_ - 1) // 2) * NMS_OPS_PER_PAIR / F32_OPS_PER_S * 1e3
    kernel_ms = prof_ms if prof_ms is not None else ev_ms
    log(f"phase 4 nms_keep_mask on {card}: B={b_} K={k_}, a cluster of "
        f"{nms_launch_config(k_)['cluster']} CTAs per image: device {prof_ms} ms/launch "
        f"(profiler), {ev_ms:.5f} ms/launch (CUDA events, 200 back to back), plain "
        f"version {plain_ms:.4f} ms; bound {max(bound_bytes_ms, bound_ops_ms):.3g} ms "
        f"(bytes {bound_bytes_ms:.3g}, operations {bound_ops_ms:.3g})")
    # A note beside the bound: the dependent chain's floor at the card's
    # clock, and the kernel's own launch on one candidate (its fixed cost:
    # the cluster launch, two cluster barriers and the scan's first step).
    clock_mhz = max_sm_clock_mhz()
    chain_ms = k_ * NMS_CHAIN_CYCLES_PER_STEP / (clock_mhz * 1e6) * 1e3
    one = cand[:1, :1].contiguous()
    one_prof_ms = profiled_device_ms(lambda: nms_keep_mask_cuda(one, thresh), 50,
                                     "nms_keep_mask")
    one_ev_ms = time_events(lambda: nms_keep_mask_cuda(one, thresh), 200)
    log(f"phase 4 nms_keep_mask floors: the K = {k_}-step chain at "
        f"{NMS_CHAIN_CYCLES_PER_STEP} cycles a step and {clock_mhz:.0f} MHz "
        f"{chain_ms:.5f} ms; one launch at B=1 K=1 {one_prof_ms} ms (profiler), "
        f"{one_ev_ms:.5f} ms (CUDA events); chain + launch "
        f"{chain_ms + (one_prof_ms or one_ev_ms):.5f} ms against the kernel's "
        f"{kernel_ms:.5f} ms")
    # What the built kernel pays per candidate, chain included: the device
    # time of one image of the suppression chain at K = 64, 256 and 1024;
    # the growth over K = 64, per added candidate, bounds the cost of one
    # step of the chain from above (phase 1 and the off-diagonal updates
    # grow with K too).
    per_k = {}
    for kk in (64, 256, 1024):
        chain = nms_chain_boxes(1, kk, dev)
        per_k[kk] = profiled_device_ms(lambda: nms_keep_mask_cuda(chain, 0.45), 50,
                                       "nms_keep_mask")
    if any(v is None for v in per_k.values()):
        log(f"phase 4 nms_keep_mask per candidate: the profiler recorded no launch "
            f"({per_k})")
    else:
        for kk in (256, 1024):
            ns = (per_k[kk] - per_k[64]) / (kk - 64) * 1e6
            log(f"phase 4 nms_keep_mask per candidate (suppression chain, B=1): "
                f"K=64 {per_k[64]:.6f} ms, K={kk} {per_k[kk]:.6f} ms by the profiler; "
                f"{ns:.3f} ns, {ns * clock_mhz / 1e3:.1f} cycles at {clock_mhz:.0f} MHz "
                f"per added candidate, at most a chain step's cost")
    report["nms_keep_mask"].update(
        max_abs_err=worst, ms=kernel_ms, plain_ms=plain_ms,
        bound_ms=max(bound_bytes_ms, bound_ops_ms),
        bound_by="bytes" if bound_bytes_ms > bound_ops_ms else "operations",
        library_ms=None,   # no single PyTorch call computes a greedy keep mask
    )

    # Where a step's device time goes: every kernel (and device copy) the
    # profiler saw in 3 steps, grouped by name.
    profile_step(lambda: step(frames), 3, card,
                 f"yolov8n bf16 serving step, {N_STREAMS}x1080x1920 uint8 "
                 f"(step {step_ms:.3f} ms wall)", "chip_smoke_profile.txt", "phase 4")

    # -- phase 5: the engine answers requests ---------------------------------
    bus = MemoryFrameBus()
    streams = [f"cam{i:02d}" for i in range(N_STREAMS)]
    for s in streams:
        bus.create_stream(s, FRAME_HW[0] * FRAME_HW[1] * 3)
    pool = frames[:4].cpu().numpy()
    engine = InferenceEngine(bus, EngineConfig(), device="cuda", model=model)
    results = engine.subscribe()
    got_results: dict = {}

    def consume():
        for r in results:
            got_results.setdefault(r.device_id, []).append(r)

    reader = threading.Thread(target=consume, daemon=True)
    reader.start()
    engine.warmup()
    zero_launches()
    engine.start()
    try:
        for packet in range(1, 5):
            for i, s in enumerate(streams):
                bus.publish(s, pool[(i + packet) % len(pool)],
                            FrameMeta(width=FRAME_HW[1], height=FRAME_HW[0], packet=packet,
                                      timestamp_ms=int(time.time() * 1000)))
            deadline = time.monotonic() + 60
            while any(engine.stats().get(s) is None or engine.stats()[s].frames < packet
                      for s in streams):
                if time.monotonic() > deadline:
                    raise AssertionError(f"engine did not serve tick {packet} within 60 s")
                time.sleep(0.005)
    finally:
        engine.stop()
    launches = read_launches()
    reader.join(10)
    if reader.is_alive():
        raise AssertionError("result subscriber did not end")
    missing = [s for s in streams if not got_results.get(s)]
    if missing:
        raise AssertionError(f"streams without results: {missing}")
    for s in streams:
        for r in got_results[s]:
            if not (0 <= len(r.detections) <= 100 and r.batch_size >= 1):
                raise AssertionError(f"bad result for {s}: {r}")
    for name, meta in kernels.items():
        if meta["path"] == "detect":
            if launches[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched on the detection path")
            report[name]["launches"] = launches[name]
    n_res = sum(len(v) for v in got_results.values())
    n_det = sum(len(r.detections) for v in got_results.values() for r in v)
    log(f"phase 5 engine: {N_STREAMS} streams at 1080p, {n_res} results, {n_det} detections, "
        f"every stream served; kernel launches {launches}")

    del engine, model
    torch.cuda.empty_cache()

    # -- phase 6: the video slice at full width -------------------------------
    from video_edge_ai_proxy_tpu_torch.models.transformer import EncoderConfig
    from video_edge_ai_proxy_tpu_torch.models.videomae import VideoMAE, VideoMAEConfig

    vspec = registry.get("videomae_b_long")
    vmodel = vspec.init_params(torch.Generator().manual_seed(0), device=dev)
    clip_len, size = vspec.clip_len, vspec.input_size
    clips = torch.randint(0, 256, (VIDEO_STREAMS, clip_len) + FRAME_HW + (3,), generator=fgen,
                          dtype=torch.uint8, device=dev)
    vstep = build_serving_step(vmodel, vspec)
    for _ in range(2):
        vstep(clips)
    torch.cuda.synchronize()
    zero_launches()
    vout = vstep(clips)
    torch.cuda.synchronize()
    step_launches = read_launches()
    n_layers = vmodel.cfg.encoder.num_layers
    if step_launches != {**{n: 0 for n in kernels}, "flash_attention_fwd": n_layers}:
        raise AssertionError(f"one videomae_b_long step launched {step_launches}, expected "
                             f"{n_layers} flash-attention launches and no other kernel")
    shapes = {k: tuple(v.shape) for k, v in vout.items()}
    if shapes != {"top_probs": (VIDEO_STREAMS, 5), "top_ids": (VIDEO_STREAMS, 5)}:
        raise AssertionError(f"videomae_b_long output shapes {shapes}")
    probs, ids = vout["top_probs"], vout["top_ids"]
    if not (bool(torch.isfinite(probs).all()) and float(probs.min()) >= 0.0
            and float(probs.sum(-1).max()) <= 1.0 + 1e-5
            and 0 <= int(ids.min()) and int(ids.max()) < vmodel.cfg.num_classes):
        raise AssertionError(f"bad videomae_b_long output: {vout}")
    log(f"phase 6 videomae_b_long step: {VIDEO_STREAMS} clips of {clip_len}x1080x1920 uint8, "
        f"{vmodel.cfg.num_tokens} tokens, shapes ok, finite, flash-attention launches per "
        f"step = {step_launches['flash_attention_fwd']}; top-5 {probs[0].tolist()}")

    # The same logits with the plain attention swapped in.
    with torch.inference_mode():
        vx = preprocess_clip(clips, (size, size))
        logits = vmodel(vx)
        set_attention(vmodel, plain_attention)
        plain_logits = vmodel(vx)
        set_attention(vmodel, None)
    swap_err = float((logits - plain_logits).abs().max())
    log(f"phase 6 videomae_b_long with the plain attention swapped in: max|dlogit| "
        f"{swap_err:.3g} (logits up to {float(logits.abs().max()):.3g}; tolerance "
        f"{VIDEO_SWAP_TOL})")
    if not swap_err <= VIDEO_SWAP_TOL:
        raise AssertionError("videomae_b_long logits move when the plain attention is "
                             "swapped in")
    del vx, plain_logits

    # float32 on the card against float32 on the CPU at full width and
    # T = 6272, on one clip; the encoder is cut to 2 of its 12 layers to
    # save CPU time.
    cfg2 = VideoMAEConfig(num_frames=clip_len, encoder=EncoderConfig(num_layers=2))
    m_cpu = VideoMAE(cfg2, torch.float32)
    m_cpu.init_weights(torch.Generator().manual_seed(0))
    m_cpu.eval()
    m_gpu = VideoMAE(cfg2, torch.float32).to(dev).eval()
    m_gpu.load_state_dict(m_cpu.state_dict())
    one = clips[:1]
    t0 = time.perf_counter()
    with torch.inference_mode():
        x_gpu = preprocess_clip(one, (size, size), out_dtype=torch.float32)
        x_cpu = preprocess_clip(one.cpu(), (size, size), out_dtype=torch.float32)
        pre_err = float((x_gpu.cpu() - x_cpu).abs().max())
        zero_launches()
        l_gpu = m_gpu(x_gpu)
        torch.cuda.synchronize()
        f32_launches = read_launches()["flash_attention_fwd"]
        l_cpu = m_cpu(x_cpu)
    f32_err = float((l_gpu.cpu() - l_cpu).abs().max())
    log(f"phase 6 f32 card vs CPU (videomae_b_long, 2 layers, 1 clip, {cfg2.num_tokens} "
        f"tokens, {f32_launches} flash launches on the card): preprocess {pre_err:.3g}, "
        f"logits {f32_err:.3g} (up to {float(l_cpu.abs().max()):.3g}); "
        f"{time.perf_counter() - t0:.1f} s")
    if not (f32_launches == 2 and pre_err <= 1e-4 and f32_err <= F32_LOGIT_TOL):
        raise AssertionError("float32 videomae_b_long on the card disagrees with the CPU")
    del m_cpu, m_gpu, x_gpu, x_cpu

    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        vstep(clips)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1000.0)
    vstep_ms = statistics.median(times)
    vpeak_mib = torch.cuda.max_memory_allocated(dev) / 2**20
    log(f"phase 6 timing on {card}: videomae_b_long bf16, {VIDEO_STREAMS} clips of "
        f"{clip_len}x1080x1920 uint8: median {vstep_ms:.3f} ms/step over 10 (min "
        f"{min(times):.3f}, max {max(times):.3f}), {VIDEO_STREAMS * 1000.0 / vstep_ms:.2f} "
        f"clips/s, peak memory {vpeak_mib:.1f} MiB")

    # The kernel's own time on the q, k, v of the step's first layer.
    captured = []

    def recording_attention(q, k, v):
        tp = packed_len(q.shape[1])
        captured.append(tuple(_pack(x, tp) for x in (q, k, v)) + (q.shape[1],))
        set_attention(vmodel, None)
        return plain_attention(q, k, v)

    set_attention(vmodel, recording_attention)
    vstep(clips)
    qp, kp, vp, true_t = captured[0]
    bh, tp, d = qp.shape
    f_err, o_err, lse_err = check_flash(qp, kp, vp, true_t)
    flash_worst = max(flash_worst, f_err)
    ev_ms = time_events(lambda: flash_attention_fwd_cuda(qp, kp, vp, true_t), 20)
    prof_ms = profiled_device_ms(lambda: flash_attention_fwd_cuda(qp, kp, vp, true_t), 10,
                                 "flash_fwd_kernel")
    plain_ms = time_events(lambda: flash_attention_reference(qp, kp, vp, true_t), 5)
    b4 = [x.view(VIDEO_STREAMS, bh // VIDEO_STREAMS, tp, d) for x in (qp, kp, vp)]
    lib_ms = time_events(lambda: torch.nn.functional.scaled_dot_product_attention(*b4), 20)
    bytes_ms, ops_ms = flash_bound_ms(bh, tp, d, true_t, qp.element_size())
    kernel_ms = prof_ms if prof_ms is not None else ev_ms
    ops = 4 * bh * true_t * true_t * d
    log(f"phase 6 flash_attention_fwd on {card}: BH={bh} Tp={tp} D={d} {qp.dtype} (the step's "
        f"first layer; O {o_err:.3g}, LSE {lse_err:.3g} from the plain version): device "
        f"{prof_ms} ms/launch (profiler), {ev_ms:.4f} ms/launch (CUDA events, 20 back to "
        f"back); plain version {plain_ms:.4f} ms; scaled_dot_product_attention {lib_ms:.4f} "
        f"ms; bound {max(bytes_ms, ops_ms):.4f} ms (bytes {bytes_ms:.4f}, bf16 operations "
        f"{ops_ms:.4f}); {max(bytes_ms, ops_ms) / kernel_ms:.2%} of the bound, "
        f"{ops / kernel_ms / 1e9:.1f} TFLOP/s of the function's {ops:.4g} operations")
    report["flash_attention_fwd"].update(
        max_abs_err=flash_worst, ms=kernel_ms, plain_ms=plain_ms,
        bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms > ops_ms else "operations",
        library_ms=lib_ms,
    )
    del captured, qp, kp, vp, b4
    profile_step(lambda: vstep(clips), 2, card,
                 f"videomae_b_long bf16 serving step, {VIDEO_STREAMS}x{clip_len}x1080x1920 "
                 f"uint8 (step {vstep_ms:.3f} ms wall)", "chip_smoke_profile_videomae.txt",
                 "phase 6")
    del vmodel, vstep, clips, logits
    torch.cuda.empty_cache()

    # -- phase 7: vit_b16 beside it -----------------------------------------------
    tspec = registry.get("vit_b16")
    tmodel = tspec.init_params(torch.Generator().manual_seed(0), device=dev)
    tframes = torch.randint(0, 256, (VIT_FRAMES,) + FRAME_HW + (3,), generator=fgen,
                            dtype=torch.uint8, device=dev)
    tstep = build_serving_step(tmodel, tspec)
    zero_launches()
    tout = tstep(tframes)
    torch.cuda.synchronize()
    if read_launches()["flash_attention_fwd"] != 0:
        raise AssertionError("vit_b16 (197 tokens) launched the flash kernel")
    if {k: tuple(v.shape) for k, v in tout.items()} != {"top_probs": (VIT_FRAMES, 5),
                                                        "top_ids": (VIT_FRAMES, 5)}:
        raise AssertionError(f"vit_b16 output shapes {[v.shape for v in tout.values()]}")
    if not bool(torch.isfinite(tout["top_probs"]).all()):
        raise AssertionError("non-finite vit_b16 probabilities")
    t32 = tspec.init_params(torch.Generator().manual_seed(0), device=dev, dtype=torch.float32)
    t32_cpu = tspec.init_params(torch.Generator().manual_seed(0), device="cpu",
                                dtype=torch.float32)
    with torch.inference_mode():
        x_gpu = preprocess_classify(tframes[:2], (224, 224), out_dtype=torch.float32)
        x_cpu = preprocess_classify(tframes[:2].cpu(), (224, 224), out_dtype=torch.float32)
        vit_err = float((t32(x_gpu).cpu() - t32_cpu(x_cpu)).abs().max())
    log(f"phase 7 vit_b16: bf16 step on {VIT_FRAMES} 1080p frames, shapes ok, finite; f32 card "
        f"vs CPU on 2 frames: logits {vit_err:.3g}")
    if not vit_err <= F32_LOGIT_TOL:
        raise AssertionError("float32 vit_b16 on the card disagrees with the CPU")
    del tmodel, t32, t32_cpu, tframes, tstep
    torch.cuda.empty_cache()

    # -- phase 8: the engine answers video requests -------------------------------
    vbus = ReadTrackingBus(MemoryFrameBus())
    vstreams = [f"clip{i}" for i in range(VIDEO_STREAMS)]
    for s in vstreams:
        vbus.create_stream(s, FRAME_HW[0] * FRAME_HW[1] * 3)
    rng = torch.Generator().manual_seed(3)
    vpool = torch.randint(0, 256, (8,) + FRAME_HW + (3,), generator=rng,
                          dtype=torch.uint8).numpy()
    vengine = InferenceEngine(vbus, EngineConfig(model="videomae_b_long"), device="cuda")
    vresults = vengine.subscribe()
    vgot: dict = {}

    def vconsume():
        for r in vresults:
            vgot.setdefault(r.device_id, []).append(r)

    vreader = threading.Thread(target=vconsume, daemon=True)
    vreader.start()
    vengine.warmup()
    zero_launches()
    t0 = time.perf_counter()
    vengine.start()
    packet = 0
    try:
        deadline = time.monotonic() + 300
        while any(len(vgot.get(s, [])) < 2 for s in vstreams):
            if time.monotonic() > deadline:
                raise AssertionError("the engine did not serve both video streams twice "
                                     "within 300 s")
            packet += 1
            seqs = {s: vbus.publish(s, vpool[(i + packet) % len(vpool)],
                                    FrameMeta(width=FRAME_HW[1], height=FRAME_HW[0],
                                              packet=packet,
                                              timestamp_ms=int(time.time() * 1000)))
                    for i, s in enumerate(vstreams)}
            while any(vbus.read.get(s, 0) < seq for s, seq in seqs.items()):
                if time.monotonic() > deadline:
                    raise AssertionError("the engine stopped reading the video streams")
                time.sleep(0.002)
    finally:
        vengine.stop()
    launches = read_launches()
    vreader.join(10)
    if vreader.is_alive():
        raise AssertionError("video result subscriber did not end")
    for s in vstreams:
        for r in vgot[s]:
            if len(r.detections) != 5 or r.detections[0].confidence <= 0.0:
                raise AssertionError(f"bad video result for {s}: {r}")
        if vgot[s][0].frame_packet != clip_len:
            raise AssertionError(f"{s}: first result from packet {vgot[s][0].frame_packet}, "
                                 f"expected {clip_len} (the first full clip)")
    for name, meta in kernels.items():
        if meta["path"] == "video":
            if launches[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched on the video path")
            report[name]["launches"] = launches[name]
    if launches["nms_keep_mask"] or launches["flash_attention_bwd_dq"] \
            or launches["flash_attention_bwd_dkv"]:
        raise AssertionError(f"the video engine launched kernels of other paths: {launches}")
    n_res = sum(len(v) for v in vgot.values())
    log(f"phase 8 engine: videomae_b_long over {VIDEO_STREAMS} streams at 1080p, {packet} "
        f"frames per stream published, {n_res} results of 5 classes each in "
        f"{time.perf_counter() - t0:.1f} s, every stream served; kernel launches {launches}")
    del vengine
    torch.cuda.empty_cache()
    # What outlives the engines of phases 5 and 8: PyTorch keeps a cuBLAS
    # workspace for every stream that ran a matmul (the default stream and
    # each engine's compute stream), and it counts as allocated memory.
    # Freed here, so that phase 9's peak counts the training alone.
    import gc

    gc.collect()
    torch.cuda.synchronize()
    alive = sum(1 for o in gc.get_objects() if isinstance(o, InferenceEngine))
    held = torch.cuda.memory_allocated(dev)
    torch._C._cuda_clearCublasWorkspaces()
    freed = held - torch.cuda.memory_allocated(dev)
    # The preprocessing constants (ops/preprocess.py) stay on the card for
    # every geometry and dtype met so far; no graph is alive to read them.
    from video_edge_ai_proxy_tpu_torch.ops import preprocess as preprocess_mod

    held_c = torch.cuda.memory_allocated(dev)
    preprocess_mod._constant.cache_clear()
    freed_c = held_c - torch.cuda.memory_allocated(dev)
    log(f"phase 8 after the engines: {alive} InferenceEngine objects alive, "
        f"{held / 2**20:.1f} MiB allocated, of which {freed / 2**20:.1f} MiB were cuBLAS "
        f"workspaces and {freed_c / 2**20:.1f} MiB preprocessing constants, now freed")

    # -- phase 9: the training slice at full width ---------------------------------
    from video_edge_ai_proxy_tpu_torch.models.videomae import (
        VideoMAEPretrain, tube_keep_mask,
    )
    from video_edge_ai_proxy_tpu_torch.ops.flash_attention import (
        KERNELS, FlashAttention, flash_attention_bwd, flash_attention_bwd_dkv_reference,
        flash_attention_bwd_dq_reference,
    )
    from video_edge_ai_proxy_tpu_torch.parallel import make_trainer

    tr_model = vspec.init_params(torch.Generator().manual_seed(0), device=dev,
                                 param_dtype=torch.float32)
    trainer = make_trainer(tr_model, device="cuda")
    state = trainer.init_state_from(tr_model.state_dict())
    clips = torch.randint(0, 256, (VIDEO_STREAMS, clip_len) + FRAME_HW + (3,), generator=fgen,
                          dtype=torch.uint8, device=dev)
    with torch.no_grad():
        tx = preprocess_clip(clips, (size, size))
    labels = torch.randint(0, tr_model.cfg.num_classes, (VIDEO_STREAMS,), generator=fgen,
                           device=dev)
    n_params = sum(p.numel() for p in tr_model.parameters())

    # One step's gradients through the kernels, and with the plain forward
    # and backward swapped in (the parameters do not move).
    t0 = time.perf_counter()
    k_loss, k_grads = step_grads(tr_model, tx, labels)
    set_attention(tr_model, plain_attention)
    p_loss, p_grads = step_grads(tr_model, tx, labels)
    set_attention(tr_model, None)
    swap_l2, swap_worst, swap_name = grad_distance(k_grads, p_grads)
    log(f"phase 9 videomae_b_long train step with the plain attention passes swapped in: "
        f"loss {k_loss:.6f} vs {p_loss:.6f}, gradients' relative L2 distance {swap_l2:.3g} "
        f"(tolerance {TRAIN_SWAP_TOL}); worst tensor {swap_name} {swap_worst:.3g} of its "
        f"largest entry; {time.perf_counter() - t0:.1f} s")
    if not (swap_l2 <= TRAIN_SWAP_TOL and all(float(g.abs().max()) > 0.0 for n, g in
                                               k_grads.items() if ".attn.qkv." in n)):
        raise AssertionError("videomae_b_long gradients move when the plain attention "
                             "passes are swapped in, or the qkv layers get no gradient")
    del k_grads, p_grads
    torch.cuda.empty_cache()

    # float32 gradients on the card against the CPU: one 16-frame clip (1568
    # tokens, still the flash route) through 2 of the 12 layers.
    t0 = time.perf_counter()
    cfg16 = VideoMAEConfig(num_frames=16, encoder=EncoderConfig(num_layers=2))
    m_cpu = VideoMAE(cfg16, torch.float32)
    m_cpu.init_weights(torch.Generator().manual_seed(0))
    m_gpu = VideoMAE(cfg16, torch.float32).to(dev)
    m_gpu.load_state_dict(m_cpu.state_dict())
    with torch.no_grad():
        x_gpu = preprocess_clip(clips[:1, :16], (size, size), out_dtype=torch.float32)
        x_cpu = preprocess_clip(clips[:1, :16].cpu(), (size, size), out_dtype=torch.float32)
    zero_launches()
    g_loss, g_grads = step_grads(m_gpu, x_gpu, labels[:1])
    f32_launches = read_launches()
    c_loss, c_grads = step_grads(m_cpu, x_cpu, labels[:1].cpu())
    f32_l2, f32_worst, f32_name = grad_distance(g_grads, c_grads)
    log(f"phase 9 f32 gradients card vs CPU (videomae, 16 frames, {cfg16.num_tokens} tokens, "
        f"2 layers, 1 clip; launches on the card {f32_launches}): loss {g_loss:.6f} vs "
        f"{c_loss:.6f}; worst tensor {f32_name} {f32_worst:.3g} of its largest entry "
        f"(tolerance {F32_GRAD_REL_TOL}), relative L2 {f32_l2:.3g}; "
        f"{time.perf_counter() - t0:.1f} s")
    if not (f32_worst <= F32_GRAD_REL_TOL and abs(g_loss - c_loss) <= 1e-4
            and f32_launches["flash_attention_bwd_dq"] == 2
            and f32_launches["flash_attention_bwd_dkv"] == 2):
        raise AssertionError("float32 videomae gradients on the card disagree with the CPU")
    del m_cpu, m_gpu, x_gpu, x_cpu, g_grads, c_grads

    # The main training path: TRAIN_STEPS steps of make_trainer.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, loss = trainer.train_step(state, tx, labels)
        losses.append(float(loss))
        times.append((time.perf_counter() - t0) * 1000.0)
    launches = read_launches()
    train_peak_mib = torch.cuda.max_memory_allocated(dev) / 2**20
    want = {**{n: 0 for n in kernels},
            **{n: n_layers * TRAIN_STEPS for n in ("flash_attention_fwd",
                                                    "flash_attention_bwd_dq",
                                                    "flash_attention_bwd_dkv")}}
    if launches != want:
        raise AssertionError(f"{TRAIN_STEPS} videomae_b_long train steps launched {launches}, "
                             f"expected {want}")
    if not all(map(math.isfinite, losses)) or state.step != TRAIN_STEPS:
        raise AssertionError(f"bad training losses {losses}")
    for name, meta in kernels.items():
        if meta["path"] == "train":
            report[name]["launches"] = launches[name]
    train_ms = statistics.median(times)
    log(f"phase 9 timing on {card}: make_trainer videomae_b_long, float32 parameters "
        f"({n_params} of them), bf16 compute, {VIDEO_STREAMS} clips of {clip_len}x224x224: "
        f"median {train_ms:.3f} ms/step over {TRAIN_STEPS} (min {min(times):.3f}, max "
        f"{max(times):.3f}), {VIDEO_STREAMS * 1000.0 / train_ms:.2f} clips/s, peak memory "
        f"{train_peak_mib:.1f} MiB; losses {losses}; kernel launches {launches} "
        f"({n_layers} of each flash kernel per step)")
    profile_step(lambda: trainer.train_step(state, tx, labels), 2, card,
                 f"videomae_b_long make_trainer step, float32 parameters, bf16 compute, "
                 f"{VIDEO_STREAMS}x{clip_len}x224x224 (step {train_ms:.3f} ms wall)",
                 "chip_smoke_profile_train.txt", "phase 9")

    # Each backward kernel's own time on the inputs of a step's backward.
    captured = []

    def recording_bwd(*args):
        if not captured:
            captured.append(tuple(a.clone() if torch.is_tensor(a) else a for a in args))
        return flash_attention_bwd(*args)

    set_attention(tr_model, lambda q, k, v: FlashAttention.apply(
        q, k, v, 128, 128, (KERNELS[0], recording_bwd)))
    step_grads(tr_model, tx, labels)
    set_attention(tr_model, None)
    qp, kp, vp, do, lse, delta, true_t = captured[0]
    errs = check_flash_bwd(qp, kp, vp, do, lse, delta, true_t)
    bh, tp, d = qp.shape
    args = (qp, kp, vp, do, lse, delta, true_t)
    q4, k4, v4 = (x.view(VIDEO_STREAMS, bh // VIDEO_STREAMS, tp, d).detach().requires_grad_()
                  for x in (qp, kp, vp))
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4)
    do4 = do.view(VIDEO_STREAMS, bh // VIDEO_STREAMS, tp, d)
    lib_ms = time_events(lambda: torch.autograd.grad(sdpa_out, (q4, k4, v4), do4,
                                                     retain_graph=True), 10)
    for name, fn, plain, part, dkv in (
            ("flash_attention_bwd_dq", flash_attention_bwd_dq_cuda,
             flash_attention_bwd_dq_reference, "flash_bwd_dq_kernel", False),
            ("flash_attention_bwd_dkv", flash_attention_bwd_dkv_cuda,
             flash_attention_bwd_dkv_reference, "flash_bwd_dkv_kernel", True)):
        err = errs["dkv" if dkv else "dq"]
        ev_ms = time_events(lambda: fn(*args), 10)
        prof_ms = profiled_device_ms(lambda: fn(*args), 5, part)
        plain_ms = time_events(lambda: plain(*args), 3)
        bytes_ms, ops_ms = flash_bwd_bound_ms(bh, tp, d, true_t, qp.element_size(), dkv)
        kernel_ms = prof_ms if prof_ms is not None else ev_ms
        ops = (8 if dkv else 6) * bh * true_t * true_t * d
        log(f"phase 9 {name} on {card}: BH={bh} Tp={tp} D={d} {qp.dtype} (a step's backward; "
            f"{err:.3g} from the plain version): device {prof_ms} ms/launch (profiler), "
            f"{ev_ms:.4f} ms/launch (CUDA events, 10 back to back); plain version "
            f"{plain_ms:.4f} ms; backward of scaled_dot_product_attention (dq, dk and dv "
            f"together) {lib_ms:.4f} ms; bound {max(bytes_ms, ops_ms):.4f} ms (bytes "
            f"{bytes_ms:.4f}, bf16 operations {ops_ms:.4f}); {max(bytes_ms, ops_ms) / kernel_ms:.2%} "
            f"of the bound, {ops / kernel_ms / 1e9:.1f} TFLOP/s of the function's {ops:.4g} "
            f"operations")
        key = "dkv" if dkv else "dq"
        report[name].update(
            max_abs_err=max(bwd_worst[key], err), ms=kernel_ms, plain_ms=plain_ms,
            bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms > ops_ms else "operations",
            library_ms=lib_ms,   # one call computes dq, dk and dv: the same on both rows
        )
    del captured, args, qp, kp, vp, do, lse, delta, q4, k4, v4, sdpa_out, do4

    # The trained weights serve: the registry's bf16 model loads them.
    serve_model = vspec.init_params(torch.Generator().manual_seed(1), device=dev)
    serve_model.load_state_dict(tr_model.state_dict(), strict=True)
    sout = build_serving_step(serve_model, vspec)(clips)
    torch.cuda.synchronize()
    if not ({k: tuple(v.shape) for k, v in sout.items()}
            == {"top_probs": (VIDEO_STREAMS, 5), "top_ids": (VIDEO_STREAMS, 5)}
            and bool(torch.isfinite(sout["top_probs"]).all())):
        raise AssertionError(f"the trained weights do not serve: {sout}")
    log(f"phase 9 serving step with the trained weights in the bf16 model: top-5 "
        f"{sout['top_probs'][0].tolist()}")
    del tr_model, trainer, state, serve_model
    torch.cuda.empty_cache()

    # -- phase 10: VideoMAE pretraining ------------------------------------------------
    pcfg = VideoMAEConfig(num_frames=clip_len)
    pmodel = VideoMAEPretrain(pcfg, torch.bfloat16, param_dtype=torch.float32)
    ptrainer = make_trainer(pmodel, device="cuda",
                            loss_fn=lambda m, batch, keep: m(batch, keep))
    pstate = ptrainer.init_state(torch.Generator().manual_seed(2))
    keep = tube_keep_mask(VIDEO_STREAMS, pcfg, 0.9, torch.Generator().manual_seed(3)).to(dev)
    zero_launches()
    plosses = []
    for _ in range(2):
        pstate, loss = ptrainer.train_step(pstate, tx, keep)
        plosses.append(float(loss))
    launches = read_launches()
    per_step = pcfg.encoder.num_layers + pcfg.decoder_layers
    want = {**{n: 0 for n in kernels},
            **{n: 2 * per_step for n in ("flash_attention_fwd", "flash_attention_bwd_dq",
                                         "flash_attention_bwd_dkv")}}
    if launches != want or not all(map(math.isfinite, plosses)):
        raise AssertionError(f"2 pretraining steps: losses {plosses}, launches {launches}, "
                             f"expected {want}")
    log(f"phase 10 videomae_b_long pretraining, {float((~keep).float().mean()):.3f} of the "
        f"tokens masked: losses {plosses}, kernel launches {launches} ({per_step} of each "
        f"flash kernel per step)")
    del pmodel, ptrainer, pstate, tx, clips
    torch.cuda.empty_cache()

    # -- phase 11: the default engine's serving pipeline ---------------------------
    pipeline = pipeline_phase(dev, card, zero_launches, read_launches, kernels)

    # -- phase 12: the compiled step ------------------------------------------------------
    graphs_phase(dev, card, report)

    # -- phase 13: the deployment's frame path ---------------------------------------------
    frame_path = frame_path_phase(dev, card, zero_launches, read_launches, kernels, report,
                                  pipeline)

    # -- phase 14: the server's planes -------------------------------------------------------
    server_phase(dev, card, zero_launches, read_launches, kernels, report, frame_path)

    # -- phase 15: the detection step's variants and the device accounting ---------------------
    variants_phase(dev, card, zero_launches, read_launches, kernels, report)

    # -- phase 16: ROI serving ------------------------------------------------------------------
    roi_phase(dev, card, zero_launches, read_launches, kernels, report, pipeline)

    # -- phase 17: the temporal cascade -----------------------------------------------------------
    cascade_phase(dev, card, zero_launches, read_launches, kernels, report)

    # -- phase 18: the other model families -------------------------------------------------------
    families_phase(dev, card, zero_launches, read_launches, kernels, report)

    # -- phases 19-23 run in processes of their own: this one's cache goes back first --------------
    release_for_children(dev)

    # -- phase 19: the chaos soak, in a process of its own ------------------------------------------
    report["nms_keep_mask"].update(run_child("--soak", "19", SOAK_CHILD_TIMEOUT_S))

    # -- phase 20: the wire run, in a process of its own ----------------------------------------
    report["nms_keep_mask"].update(run_child("--e2e", "20", E2E_CHILD_TIMEOUT_S))

    # -- phase 21: the camera tier, in a process of its own ------------------------------------
    run_child("--camera", "21", CAMERA_CHILD_TIMEOUT_S, json.dumps({"13b": frame_path}))

    # -- phase 22: the fleet tier, in a process of its own -------------------------------------
    report["nms_keep_mask"].update(run_child("--fleet-tier", "22", FLEET_TIER_CHILD_TIMEOUT_S))

    # -- phase 23: the self-training loop, in a process of its own -------------------------------
    report["nms_keep_mask"].update(run_child("--selftrain", "23", SELFTRAIN_CHILD_TIMEOUT_S))
    log(f"chip_smoke: phases 1-23 took {time.perf_counter() - t_script:.1f} s")

    line = {"kernels": []}
    for name, meta in kernels.items():
        r = report[name]
        line["kernels"].append({
            "name": name, "route": meta["route"], "source": meta["source"],
            **({"source_f32": meta["source_f32"]} if "source_f32" in meta else {}),
            **({"replay_ms": r["replay_ms"]} if "replay_ms" in r else {}),
            **({"launches_frame_path": r["launches_frame_path"]}
               if "launches_frame_path" in r else {}),
            **({"launches_server": r["launches_server"]} if "launches_server" in r else {}),
            **({"launches_variants": r["launches_variants"]}
               if "launches_variants" in r else {}),
            **({"launches_roi": r["launches_roi"]} if "launches_roi" in r else {}),
            **({"launches_cascade": r["launches_cascade"]} if "launches_cascade" in r else {}),
            **({"launches_fleet": r["launches_fleet"]} if "launches_fleet" in r else {}),
            **({"launches_soak": r["launches_soak"]} if "launches_soak" in r else {}),
            **({"launches_e2e": r["launches_e2e"]} if "launches_e2e" in r else {}),
            **({"launches_fleet_tier": r["launches_fleet_tier"]}
               if "launches_fleet_tier" in r else {}),
            **({"launches_capacity": r["launches_capacity"]}
               if "launches_capacity" in r else {}),
            **({"launches_selftrain": r["launches_selftrain"]}
               if "launches_selftrain" in r else {}),
            **({"replay_ms_yolov8s": r["replay_ms_yolov8s"]} if "replay_ms_yolov8s" in r else {}),
            "replaces": meta["replaces"], "launches": r["launches"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    CHILDREN = {"--fleet": fleet_main, "--soak": lambda: child_main(soak_phase),
                "--e2e": lambda: child_main(e2e_phase),
                "--camera": lambda: child_main(camera_phase),
                "--fleet-tier": lambda: child_main(fleet_tier_phase),
                "--selftrain": lambda: child_main(selftrain_phase)}
    sys.exit(CHILDREN[sys.argv[1]]() if sys.argv[1:2] and sys.argv[1] in CHILDREN
             else main())
