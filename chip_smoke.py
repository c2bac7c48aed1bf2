#!/usr/bin/env python3
"""Drive hive_tpu_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. the card's name and power limit (``nvidia-smi``), whether ``ffmpeg``
   and ``ffprobe`` are on PATH, what ``ctypes.util.find_library`` finds
   for ``avcodec``, ``avformat``, ``avutil``, ``swscale`` and ``nvcuvid``,
   the container's ``NVIDIA_DRIVER_CAPABILITIES`` and what
   ``cuvidGetDecoderCaps`` says of 8-bit 4:2:0 H.264, HEVC, MPEG-4, VP9 and
   AV1 at 1920x1440 (logged, never failing);
2. build all seven CUDA kernels from ``hive_tpu_torch/csrc`` (one ``nvcc``
   each, started together), then the native host library (``g++``: the
   extraction weld, the QEM decimation, the JPEG scan decode, the PNG
   unfilter, Telea's inpainting and the MPEG-4 Part 2 VOP decode);
3. the block classification, both instantiations (pass 1 and the refine
   pass, one launch each) vs the plain classification on a bench frame with
   10% invalid depth pixels, without compaction, with the 0.375 cap and
   with a cap that overflows, and on a SUB = 2 small volume (classes and
   refined windows): bit-exact; both timed at the bench shape;
4. band-update kernel vs its plain version on a whole frame's band at the
   bench shape (f32 state, after two frames), timed; the same bit-exact
   check on a small volume in each of the four {f32, bf16} x {rgb565d16,
   rgb888} states at SUB = 1 and at SUB = 2; and the band-sampler kernel vs
   its plain version on one 128-block trip and on a whole frame's band:
   bit-exact, timed beside ``torch.take``;
5. integration at the TSDF bench shape (VGA x 64 frames into a 256^3
   volume, the wavy-wall scene made on the card): the kernel path and the
   plain path give bit-identical states, with exactly two classification
   launches and one band update per frame; voxel-updates/s, median of 5
   reps; one traced rep logs the device busy share and the counts of
   ``aten::nonzero``, ``aten::add`` and ``aten::mul``; plus the
   sparse-vs-dense self-check on a small volume;
6. the main path through the CLI entry point (``python -m hive_tpu_torch``,
   foreground and background, run in this process) on a 30-frame 640x480
   synthetic HIVE dataset this script writes, at the default 5 mm / 320M
   voxel budget: ``bg.glb`` must load and carry the scene's colour
   gradients; ``fg.glb`` must hold one textured mesh per frame (nodes
   ``000000``-``000029``, UVs in [0, 1], median texel the blob's
   (200, 64, 64) +- 2) with the blob 0.2-0.8 m in front of the wall;
   ``profiling.json`` must carry the foreground roll-ups (count >= 30), a
   native QEM decimation far below the triangulated face count, and
   ``fg.glb`` compressed by quantization (``bg.glb``'s 284 MB host
   quantize is left out of this run and the video runs; the TUM and
   [research] runs check it). The
   foreground stage runs on host
   threads beside the background stage and launches nothing on the card.
   Kernel launch counts are reset just before and read just
   after this run: two classification launches (pass 1, refine) and one
   band update per frame. Every kernel call of the run is also made
   through its plain version on the same inputs and must agree bit for bit
   (classes and windows; the band update's plain version runs on a
   snapshot of the frame's band rows, which raises the run's peak device
   memory); the kernels are then timed on the run's largest call (the
   classification's by the blocks that read the pyramid; the band update
   on the volume's own state). The ``[io]`` line times the host's frame
   decoders on one of its frames: PNG with filter 0 and with adaptive
   filters, and the frame as a quality-75 JPEG, native and plain (which
   must agree);
6a. [shard]: the multi-device layer (``--num_devices``) split k ways on
   this one card (a mesh that names it k times), every number labelled as
   k shards on one card beside the card's name and power limit, none a
   multi-card one. The bench integration split 2 ways in both placements
   (a 4-way split is left out, for the script's time): states
   bit-identical to the unsplit kernel path (and, for the cyclic splits,
   to their plain paths), two classification launches
   per frame and shard, and (cyclic) one band update; on bench frame 0
   each slab's classification and band update bit-exact against their
   plain versions. The e2e dataset of phase 6 through ``fusion.tsdf_fusion``
   at the 320M budget, unsplit and split 2 ways: equal meshes. The CLI with
   ``--num_devices`` on a small dataset: 2 refused before anything is
   written on one card (naming the device counts), else ``bg.glb`` equal
   to 1's; -1 runs the single-device path on one card, ``bg.glb`` equal to
   1's. DPT bf16 ``predict_batch`` at 8x480x640 split 2 ways within
   DPT_CPU_BF16_TOL of the unsplit depth, and pose-optimise's problem in
   float64 split 2 ways within POSE_SHARD_TOL of the unsplit run (two
   unsplit runs' spread logged beside it). Device ms (the bench's a frame,
   from a traced rep of SHARD_TRACED_FRAMES frames), launches and peak
   memory of each split and of the unsplit runs;
7. a user's run on a TUM sequence: the script writes a 30-frame 640x480
   TUM folder (adaptive PNGs, depth at 5000 units a metre, ground truth at
   100 Hz, a static camera, a blob jumping about in front of a textured
   wall), times one MOG2 step and the open and close on the card, then runs
   ``python -m hive_tpu_torch --dataset_path <tum> --output_path <new>
   --key_frame_threshold 1.0`` (every frame fused: the camera is static)
   in this process with nothing patched: it converts the folder (JPEG
   frames, motion masks on the card) and meshes it. Launch counts are reset
   just before and read just after: two classifications and one band
   update a frame. The converted folder must be a HIVE dataset of ``.jpg``
   frames; its masks must equal the CPU path's on the same frames; the blob
   found in each frame after the priming batch with IoU >= 0.7 against its
   silhouette; ``fg.glb`` must hold a textured node for each of those
   frames and ``bg.glb`` finite vertices. Logs the ``load_dataset`` stages
   and both CLI runs' stage times side by side;
8. depth from RGB. DPT-Hybrid at full width on the card (R50 stem, ViT-B/16,
   256-wide fusion, NYU head), with the check weights from the seed
   (``check_flax_params``): its float32 logits equal the CPU's on a
   (2, 64, 96) batch within the CPU parity test's tolerance, its bf16
   logits the CPU's bf16 within DPT_CPU_BF16_TOL; at the graft entry's
   2x256x320 and the CLI's 8x480x640, bf16 and float32 logits finite and
   within DPT_BF16_TOL of each other; one forward timed per shape and dtype
   (device ms, launch loop), with frames/s, the analytic FLOPs
   (``dpt_flops``), TFLOP/s, its share of the data-sheet peak and peak
   device memory. Then a user's run with ``--estimate_depth`` on phase 7's
   TUM folder, nothing patched, with the check weights written as
   ``$WEIGHTS_PATH/dpt_hybrid_nyu.npz`` (the head mapped to ~2 m by the
   NYU calibration): 30 uint16 640x480 depth PNGs spanning at least
   DEPTH_MIN_SPAN_MM, each within 1 mm of this script's own
   ``predict_batch`` on the converted frames; ``metadata.json`` says
   ``estimate_depth``; two classifications and one band update a frame;
   both meshes finite; ``get_depth_maps`` logged beside the GT-depth run's
   stages;
9. the weighted person segmenters, with check weights from the seed
   (``maskrcnn.check_params``, ``segmentation.unet_check_params``): Mask
   R-CNN (ResNet-50 FPN, 91 classes, float32) on the card against the CPU
   on phase 7's frames subsampled to 120 x 160 (the CPU tests' 192 x 256
   canvas): validity equal, scores, boxes and masks within the CPU tests'
   tolerances, instance ids equal away from 0.5; the U-Net's probabilities
   within UNET_CPU_TOL of the CPU's; then a batch of 8 VGA frames through
   each (Mask R-CNN at its 832 x 1088 canvas, where cuDNN picks other
   algorithms), the batch's first frame held to its result alone and to
   the CPU's forward of it at the same tolerances, and timed: device ms,
   launch loop, frames/s, the analytic FLOPs (``maskrcnn_flops``,
   ``unet_flops``), TFLOP/s and its share of the float32 peak, peak
   device memory, the top kernels and cuDNN's FFT
   and Winograd kernels. Then a user's run on phase 7's TUM folder with the
   check weights written as ``$WEIGHTS_PATH/maskrcnn_coco.npz``, nothing
   patched: the 30 mask PNGs equal this script's own ``predict_batch`` on
   the converted frames, an instance in more than half the frames, two
   classifications and one band update a frame, both meshes finite;
   ``create_instance_segmentation_masks`` logged beside phase 7's motion
   masks;
10. inpainting behind moving objects. big-lama at full width on the card
   (ngf 64, 3 downsamples, 18 FFC residual blocks, global ratio 0.75), with
   the check weights from the seed (``lama.check_params``), on two 60 x 84
   frames (padded to 64 x 88): float32 equals the CPU's within the CPU
   parity test's tolerance (LAMA_F32_TOL); bf16 the CPU's within
   LAMA_BF16_TOL, and no further from the CPU's float32 than
   LAMA_BF16_ERROR_RATIO times the CPU's bf16 is (LAMA_BF16_TOL says why
   the CPU tests' bf16 tolerance cannot hold on the card); both outputs
   float32; each convolution and folded norm of the bf16 generator, fed
   the CPU's input to it, within the leaf check (LAMA_LEAF_SHARE,
   LAMA_LEAF_REL, LAMA_BF16_LEAF_DTYPES), and two bf16 faults planted on
   the card (the Fourier unit's conv in float32, the folded norms in bf16)
   must fail it; then in bf16, as the CLI runs it, a batch of 8 of phase
   7's VGA frames, each with a 255-valued hole over 25% of it: each frame
   within LAMA_BF16_TOL of its forward alone, known pixels passed through
   exactly, one forward timed (device ms, launch loop, frames/s,
   ``lama_flops``, TFLOP/s and its share of the bf16 peak, peak device
   memory, the top kernels, the FFT kernels' share).
   Then a user's run with ``--inpainting_mode 2`` (LaMa for RGB, TELEA for
   depth) on phase 7's TUM folder, the check weights written as
   ``$WEIGHTS_PATH/big-lama.npz``, nothing patched: ``rgb_inpainted/``,
   ``depth_inpainted/`` and ``mask_inpainted/`` with 30 files each, the
   masks there all zero, the RGB frames equal this script's own
   ``LamaInpainter`` on the converted frames and dilated masks (as
   quality-95 JPEG bytes), known depth kept and, in the frames after
   priming whose dilated mask covers the whole blob (at least half of
   them), the hole's depth within INPAINT_DEPTH_TOL_MM of the 2 m wall, one frame's
   depth equal to ``inpaint_telea``'s, two classifications and one band
   update a frame, both meshes finite; ``inpainting`` logged beside phase
   7's stages;
11. the pose optimiser's training loop (no kernel of its own: plain
   PyTorch and autograd, Adam in optax's order). First
   tests/test_pose_optimisation.py's 8-frame, 120-landmark problem on the
   card against the CPU port: one 25-epoch chunk's losses within
   POSE_LOSS_RTOL and parameters within POSE_CHUNK_TOL (frame 0
   unmoved); two steps and the fine-tune through
   ``optimise_packed_features`` in float64 with the same epochs a loop,
   within POSE_RUN_TOL, the ATE RMSE under POSE_ATE_RATIO of the perturbed
   input's. Then pose-optimise at a user's size: a 300-frame VGA sweep
   (fx = 525), 593 hierarchical pairs, about 300 correspondences a pair
   (0.5 px noise), the ground truth perturbed by 0.05 m and 1 degree,
   held to the CPU port at this size (``check_pose_user_chunk``: the first
   25-epoch chunk in float64 within POSE_LOSS_RTOL and POSE_CHUNK_TOL, the
   float32 loss within POSE_LOSS_RTOL of the CPU's float64 and the float32
   gradients within POSE_F32_GRAD_RATIO x the CPU's own float32 error),
   then through ``PoseOptimiser`` with ``OptimisationOptions()``
   (PairWise3D, Global3D, the fine-tune): per loop the epochs, wall s and
   peak device memory, and a chunk of its configuration profiled (device
   ms and kernels an epoch) and as a launch loop (CUDA events); the final
   ATE RMSE beside the perturbed input's;
12. tum-fts: a user's run with ``--fts_num_epochs 100`` on a copy of phase
   7's TUM folder whose ground truth is jittered (FTS_JITTER_M,
   FTS_JITTER_ROT), nothing patched: two classifications and one band
   update a frame, both meshes finite, ``stages_overlapped`` false,
   ``foreground_reconstruction`` logged beside phase 7's; the foreground
   optimiser on the converted folder on the card (timed) within FTS_TOL of
   the CPU port's, the trajectory moved by more than FTS_MIN_MOVE_TOLS x
   FTS_TOL;
13. tum-colmap-pose: a user's run with ``--estimate_pose`` on a copy of
   phase 7's TUM folder whose camera moves COLMAP_STEP_M along x between
   frames, ``--binary_path`` a stand-in ``colmap`` the phase writes (a
   sparse model of the staged frames from the TUM ground truth in units of
   COLMAP_SCALE metres, points on the wall): two classifications and one
   band update a frame, both meshes finite, ``camera_matrix.txt`` the
   model's, the trajectory and each step between frames within
   COLMAP_POSE_TOL_M of the ground truth's (a missing scale would leave
   steps of COLMAP_SCALE x COLMAP_STEP_M), the metric scale (recomputed
   from the sparse depth maps) within 1% of 1 / COLMAP_SCALE;
   ``get_camera_parameters`` logged;
14. the probe kernels at the measurement entry points' shapes: the
   tile-gather kernel, both axes, on the gather probe's (8, 128) tile,
   bit-exact vs its plain version, timed beside ``torch.gather``; the
   patch-gather kernel on the probe's 1024 blocks x 512 samples, with one
   sample in eight moved out of its window, bit-exact vs its plain
   version, timed beside ``torch.take`` and the band sampler; both fused
   band-trip variants on the fused-trip probe's 128-row trip, bit-exact vs
   the plain version, timed;
15. [sift]: the feature and pose layer (no kernel of its own: plain
   PyTorch) at full width on two VGA frames of the textured wall
   (``render_wall``): SIFT with 2048 features on the card against the
   port's CPU run on the same frames, TF32 off (KP_SHARE of each side's
   keypoints within 0.5 px of the other's, DESC_SHARE of the common ones'
   descriptors within DESC_L2); the exact k-NN of the CPU's descriptors on
   the card equal to the CPU's; the extractor's homography filter
   (H_SYMDIFF) and the odometry's RANSAC PnP (PNP_SYMDIFF, PNP_ROT_DEG,
   PNP_T_M) on the card against the CPU on the same matches; each stage
   timed (device ms and kernels, launch loop), keypoints, matches and
   inliers, peak device memory, with the card's name and power limit;
16. tum-pnp-pose: a user's run with ``--estimate_pose`` and no COLMAP
   binary on a 30-frame VGA TUM folder of the textured wall, the camera
   sliding 1 cm and turning 0.15 degrees a frame (``write_wall_tum``),
   nothing patched: PnP odometry on the card at the CLI's frame step 15,
   two classifications and one band update a frame, both meshes finite,
   the ATE within PNP_ATE_M of the ground truth, ``get_camera_parameters``
   logged beside phase 13's stand-in COLMAP; then ``python -m
   hive_tpu_torch.pose_optimisation`` on the converted folder with no
   cached feature set: the extraction time, the pairs kept and the whole
   CLI's time logged;
17. [video]: video and Stray Scanner inputs (host demuxing; JPEG, MPEG-4
   Part 2, H.264 and HEVC decode on the host; plain PyTorch; PnP's SIFT sums its
   histograms in the ordered kernel). Three seeded I_PCM H.264 MP4s
   (640x480 x 30 frames in display order, the same coded out of order
   with ``ctts``, 1920x1080 x 10 frames, cropped from 1088 lines): the
   demuxer's size, count and rate as written, ``H264Decoder``'s planes
   equal to the seeded samples on the CPU and through the card's capture;
   NVDEC's parser logged (not on the decode path, ROADMAP item 9b); the
   card's YUV -> BGR conversion equal to the CPU's on the same planes
   (device ms, kernels, peak memory). Ten H.264 exerciser clips at VGA
   (``video.h264.Exerciser``: every macroblock, slice, reference and
   marking path the writer counts, written at least once over them, on
   integer-made frames; six High profile clips, CABAC with each
   cabac_init_idc and CAVLC, with the 8x8 transform and scaling lists;
   three with B pictures, each direct mode and weighted prediction;
   coding every CABAC context I, P and B slices can read under each of the
   four tables): each file, and its frames on the card and on the CPU,
   hashing to the digests the tests hold to cv2 (cv2 5.0.0 is not on the
   card's machine); the same for eight HEVC exerciser clips at VGA
   (``video.hevc.Exerciser``: four of intra pictures with CTBs of 16, 32
   and 64, four of P and B pictures in GOPs with open and closed CRA
   pictures, BLA pictures, long-term references, sub-layers and pictures
   not output; every syntax path the
   writer counts, and every context of I, P and B slices under each of
   HEVC's three CABAC tables). The card's rotation and uint8
   resize equal to the CPU's at the phone clip's (1920x1080 -> 640x360)
   and the Stray Scanner capture's (1920x1440, turned to portrait, ->
   480x640) shapes, timed. The phone clip: 30 1080p frames of phase 16's
   textured wall as Motion JPEG (the port's ``encode_jpeg``, 4:2:0, in an
   ``mp4v`` / 0x6C track as cv2's MJPG writer stores it): read on the card
   and the CPU alike (frames 0 and 29 equal), the host decode ms a frame,
   the card's conversion device ms. The same 30 renders as an MPEG-4 Part
   2 phone clip (``video.mpeg4.write_mpeg4_mp4``: Simple Profile, what
   cv2's default ``mp4v`` writer makes; an I-VOP every 12 frames, the
   wall's motion as 1MV / 4MV vectors, a video packet a row, 1088 coded
   lines) and as two H.264 ones (``video.h264.write_h264_mp4``: CAVLC, an
   IDR picture every 12 frames, the wall's motion to each of up to four
   references, a slice a row, deblocking on; and as x264 codes a clip at
   its defaults: High profile, CABAC, the 8x8 transform, P pictures with
   explicit weights and 2-3 B pictures between them in a pyramid, spatial
   direct, implicit B weights, max_num_reorder_frames 2): decoded on the
   host (native), frames 0, 11, 12 and 29 on the card equal to the CPU's
   and their luma above a stated PSNR against the renders, the intra, a P
   and (x264's) a reference and a non-reference B picture's host decode
   ms, the card's conversion, a ``frames()`` loop; and the first 12
   renders as HEVC as x265 codes a clip at its medium preset
   (``video.hevc.InterPlanner``: CTB 64, P anchors every 5 pictures and a
   pyramid of four B pictures between them, an open-GOP CRA picture at 10
   with its RASL pictures, weightp tables, TMVP, MaxNumMergeCand 3, SAO,
   sign hiding, four slices): the file and the 12 frames the card reads
   hashed to PHONE_HEVC_DIGESTS (cv2's), frames 0, 5, 6 and 11 card = CPU
   and above PHONE_HEVC_MIN_PSNR, the host decode ms of its IDR, a P, a
   reference B and a non-reference B picture. A small clip whose SPS codes fields, and
   an HEVC clip whose SPS asks for scaling lists, refused by the CLI naming
   ROADMAP items 9f-4 and 9c-3 before anything is written. The Stray Scanner capture's rgb.mp4
   coded as the app codes it (High profile, CABAC, the 8x8 transform,
   1920x1440): frames 0, 11, 12 and 29 on the card equal to the CPU's,
   their luma above STRAY_MIN_PSNR against the renders, its IDR and a P
   picture's host decode ms beside the card's name and power limit. Then
   the user's runs through ``python -m
   hive_tpu_torch`` in this process: the Motion JPEG, MPEG-4, x264-shaped
   H.264 and HEVC phone clips with
   ``--estimate_pose --estimate_depth`` (PnP odometry, DPT with phase 8's
   check weights; ``--key_frame_threshold 1.0``, every frame fused, as in
   the other CLI runs) on their first PHONE_CLI_FRAMES frames, and the 30-frame Stray
   Scanner capture (that rgb.mp4, 256x192 depth and confidence, the first
   pose rolled -90 degrees) with its own
   poses: two classifications and one band update a frame, the ordered
   histogram launched on the pose runs, ``fg.glb``, ``bg.glb`` and
   ``metadata.json`` written (``bg.glb`` unquantized, as in the e2e run),
   finite meshes, the frames equal to the CPU path's JPEG bytes;
18. [eval]: the evaluation path and the player on phase 7's export (no
   kernel of its own: plain PyTorch and host code). ``bg.glb`` with each
   frame's ``fg.glb`` node rendered from the 30 ground-truth poses at
   640x480 on the card (the export's upright turn undone, its centring
   offset estimated from the depth maps' bounds): each view covering at
   least 90% of the frame, its depth within EVAL_DEPTH_MEDIAN_M (median) of
   the input depth away from the masks; one view timed (device ms,
   kernels, launch loop, candidate pixels, peak device memory) and
   rendered on the CPU too, differing at no more than EVAL_EDGE_PIXELS
   pixels; three frames scored against the input frames:
   ``batch_ssim_psnr`` on the card within EVAL_SSIM_TOL / EVAL_PSNR_TOL_DB
   of the host's ``ssim`` / ``psnr``, LPIPS with check weights
   (``lpips.check_params``) within EVAL_LPIPS_RTOL of the CPU's and MIFD
   equal to the CPU's (EVAL_MIFD_RTOL 0; also on two of phase 16's textured
   wall frames, where it must be finite), each timed; an LLFF folder at fern's
   factor-8 size (504x378, 20 JPEG views, the poses in the export's frame)
   through ``LLFFDataset`` and ``evaluate_renders`` on its held-out views
   (SSIM, PSNR and LPIPS finite); one view of phase 6's unquantized
   ``bg.glb`` (5.9M vertices) timed with its candidate pixels and peak memory; then the viewer's
   server on a free local port: the page and ``bg.glb`` plain and
   gzip-encoded byte for byte, a missing file 404;
18a. [research]: the research entry points (no kernel of their own; the
   harness's fusions launch the main path's three). experiments-tum:
   ``hive_tpu_torch.scripts.experiments.main`` in this process on phase
   7's TUM folder with the groups pipeline, export, trajectory, compression,
   mesh_compression and inpainting and the configs gt and est (PnP pose
   without COLMAP, DPT-Hybrid's weights-absent init; the cm config is cut
   for the time limit), ``--num_frames 30``
   at the CLI's default 320M-voxel budget: each config's pipeline run
   launches two classifications and one band update per integrated frame,
   the gt run's ``bg.glb`` is byte-equal to a ``python -m hive_tpu_torch``
   run with the options the harness passes (``--num_frames 30
   --frame_step 15``), every JSON and LaTeX file the groups write parses,
   the ATE of est is finite; each group's and config's wall time and
   the peak device memory are logged. compare-pair: ``compare_images`` on
   the card and on the CPU, on a rendered view of the gt export against
   the photo it replaces (640x480) and on the panoptic nodes' synced
   1920x1080 frames (whole on the card, card and CPU held equal on their
   top-left PANOPTIC_CPU_CROP): SSIM and PSNR within COMPARE_SSIM_PSNR_RTOL, MIFD
   equal (EVAL_MIFD_RTOL 0), LPIPS NaN and labelled without weights; device
   ms and kernels of each metric on the whole images. panoptic: a synthetic Kinoptic capture at
   the dataset's sizes (10 nodes, 1080p JPEGs, 512x424 u16
   ``depthdata.dat``, drifting sync streams that drop a frame): 2 nodes x 5
   HD frames load as the colour frame and depth row the sync search must
   select, the host ms of each pair logged. ordered_hist: SIFT on one
   node's 1080p frame twice on the card and once on the CPU, keypoints and
   descriptors equal bit for bit; the kernel equal to its plain version
   (the CPU's in-order ``scatter_add_``) on ORDERED_HIST_LAYOUTS (one bin,
   signed zeros, indices out of range, runs, ragged and empty rows, 1 and
   512 bins) and on the run's largest orientation and descriptor calls,
   each call timed beside ``scatter_add_`` on the card, beside it under
   ``torch.use_deterministic_algorithms(True)`` (its bits compared with
   the plain version's too) and beside its bound;
19. the two measurement entry points, each run in this process with the
   launch counts reset just before and read just after:
   ``hive_tpu_torch.micro.gather`` (Q1 tile gathers, Q2 patch gather timed
   beside ``torch.take`` and the band sampler) and
   ``hive_tpu_torch.micro.fused_band`` (Q2: both fused trips equal the
   production trip; Q3: fused, production and take trips timed, their final
   states bit-identical on the rows that fit); each of its kernels must have
   launched;
20. one ``{"kernels": [...]}`` line (times, errors and bounds at the main
   paths' shapes, and under ``bench`` at the bench shape; ``ordered_hist``'s
   launches are the phone run's, its times the 1080p descriptor call's,
   beside the shapes of the phone run's and tum-pnp-pose's calls; the probe
   kernels' entries carry the launch floor, a one-element ``add_``'s
   device time, measured before phase 15),
   then the card's
   ``nvidia-smi`` line, then ``{"ok": true, "device": {...}}`` as the last
   line.

Kernel and plain times are device time from torch.profiler's CUPTI trace;
``loop_ms`` is a Python loop of launches timed with CUDA events, host cost
included. The band update and the refine pass change what they run on, so
each of their timed launches runs on their inputs as they were before the
call, written back before it; the band update and both classification
passes are timed with the L2 flushed before each launch; the
band update runs once per frame, so it has no ``loop_ms``, and the
classification's ``loop_ms`` is its wrapper's pace on inputs it has
already classified. ``bound_ms`` is the larger of the bytes the call must
move over the HBM rate and its operations over the card's non-tensor-core
peak; the band update's counts the state of the voxels the frame updates,
not of every band voxel, and the classification's the pyramid words of the
blocks whose class depends on them.

It needs one CUDA card and exits non-zero without one, printing no result.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import runpy
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from typing import Tuple
from unittest import mock

import numpy as np
import torch

from torch.profiler import ProfilerActivity, profile

from hive_tpu_torch.micro import timing
from hive_tpu_torch.micro.timing import device_profile, device_us, events_ms, self_device_us

SEED = 0
REPO = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet), for the bounds: HBM rate,
# and the float32 rate outside the tensor cores, the nearest listed peak for
# the kernels' integer work.
HBM_BYTES_PER_S = 3.35e12
SIMT_OPS_PER_S = 67e12

BENCH_FRAMES, BENCH_H, BENCH_W, BENCH_GRID = 64, 480, 640, 256
E2E_FRAMES, E2E_H, E2E_W = 30, 480, 640


def log(msg: str) -> None:
    print(msg, flush=True)


def device_time_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Device ms per call of ``fn()``: the kernels' own device time from
    torch.profiler's CUPTI trace, which leaves out the host's launch cost."""
    return device_profile(fn, reps, warmup)[0]


def bound(num_bytes: float, int_ops: float):
    """(bound ms, what bounds it): the larger of the bytes over the HBM rate
    and the integer operations over the card's non-tensor-core peak."""
    bytes_ms = 1e3 * num_bytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * int_ops / SIMT_OPS_PER_S
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


# Operations of the classification kernel (csrc/classify_blocks.cu), each f32
# or integer operation counted once (a division, log2 or ceil as one): per
# block projected, 8 corners of 36 (corner 3, camera coordinates 18, z clamp
# 1, u and v 6, the four border planes' mul and add 8), the hull's min/max
# (10) for each corner after the first, and 36 for the border planes'
# constants (6), the hull tests, the candidate test and the class; per block
# that reads the pyramid, 40 for the level pick, the four clamped cells and
# the decode, and 13 per cell (index 5, bounds clamp 2, fields 3,
# reductions 3).
CLASSIFY_OPS = dict(corner=36, hull=10, block=36, query=40, cell=13)
# What the classification's bound counts, reported beside its times.
CLASSIFY_COUNTS = ("blocks", "projected", "reads", "words", "changed")


def distinct_words(layout, bounds, geom, grid_bias):
    """How many distinct pyramid words the blocks of ``bounds`` (u0, u1,
    v0, v1) read at ``grid_bias`` = (grid, level bias)."""
    from hive_tpu_torch.ops import classify_blocks as cb

    grid, bias = grid_bias
    off, w_l, cu0, cu1, cv0, cv1 = (c.long() for c in cb.pyramid_cell_bounds(
        layout, *bounds, geom.height, geom.width, bias))
    step = torch.arange(grid, device=off.device)
    cv = torch.minimum(cv0[:, None] + step, cv1[:, None])
    cu = torch.minimum(cu0[:, None] + step, cu1[:, None])
    idx = off[:, None, None] + cv[:, :, None] * w_l[:, None, None] + cu[:, None, :]
    return torch.unique(idx).numel()


def classify_counts(name: str, inputs) -> dict:
    """What one classification call must do on these inputs: blocks, blocks
    projected, blocks whose class depends on the pyramid (which read it),
    distinct pyramid words they read, classes changed (refine)."""
    from hive_tpu_torch.ops import classify_blocks as cb

    if name == "classify_pass1":
        origins, scal, pyramid, geom, cap = inputs
        nb = origins.shape[0]
        projected = torch.ones((nb,), dtype=torch.bool, device=origins.device)
        changed = 0
    else:
        before, origins, scal, pyramid, geom, cap, windows = inputs
        nb = origins.shape[0]
        projected = (before == cb.BAND) & (cb.band_rank(before) <= cap)
        after = before.clone()
        cb.classify_refine_plain(after, origins, scal, pyramid, geom, cap, windows)
        changed = int((after != before).sum())
    R, t, intr = scal[:9].view(3, 3), scal[9:12], tuple(scal[12:16])
    in_front, _, _, u0, u1, v0, v1, outside = cb.project_corners(origins[projected], R, t,
                                                                 intr, geom)
    if name == "classify_pass1":
        reads = in_front & cb.overlaps_image(u0, u1, v0, v1, geom)
        if cap < nb:
            reads &= cb.pass1_candidates(in_front, u0, u1, v0, v1, outside, geom)
        grid_bias = cb.PASS1
    else:
        reads = in_front
        grid_bias = cb.REFINE
    words = distinct_words(geom.layout, [x[reads] for x in (u0, u1, v0, v1)], geom, grid_bias)
    return dict(blocks=nb, projected=int(projected.sum()), reads=int(reads.sum()), words=words,
                changed=changed, band=int((inputs[0] == cb.BAND).sum()) if name != "classify_pass1"
                else None)


def classify_bound(name: str, inputs, counts: dict):
    """The classification call's least time. Bytes: the origin of each
    block projected (12 B), each distinct pyramid word once, the 64 B of
    scalars; pass 1 writes every class (4 B) and, with a cap, every
    candidate flag (1 B); the refine pass reads every class, the rank of
    each BAND block, writes each class it changes and, with windows, 9 B of
    window per block. Operations: CLASSIFY_OPS for the blocks projected and
    the blocks that read the pyramid."""
    from hive_tpu_torch.ops import classify_blocks as cb

    nb, projected, reads = counts["blocks"], counts["projected"], counts["reads"]
    grid = (cb.PASS1 if name == "classify_pass1" else cb.REFINE)[0]
    ops = (projected * (8 * CLASSIFY_OPS["corner"] + 7 * CLASSIFY_OPS["hull"]
                        + CLASSIFY_OPS["block"])
           + reads * (CLASSIFY_OPS["query"] + grid * grid * CLASSIFY_OPS["cell"]))
    common = projected * 12 + counts["words"] * 4 + 64
    if name == "classify_pass1":
        cap = inputs[4]
        return bound(common + nb * 4 + (nb if cap < nb else 0), ops)
    windows = inputs[6]
    return bound(common + nb * 4 + counts["band"] * 4 + counts["changed"] * 4
                 + (nb * 9 if windows else 0), ops)


def time_classify(name: str, inputs) -> dict:
    """Kernel, glue, plain and launch-loop times of one classification
    call, and its bound. ``ms`` is the kernel's own device time, each launch
    after an L2 flush (on the main path the band update has streamed the
    state through the L2 before the next frame's classification), ``glue_ms``
    that of the wrapper's cumsum / where glue around it (work that does not
    depend on the values, timed on zeros of its shapes). The refine pass
    classifies in place, so each timed launch runs on the classes as they
    were before the call, written back before it; the classes after the
    timed launches must equal one plain call's."""
    from hive_tpu_torch.ops import classify_blocks as cb

    counts = classify_counts(name, inputs)
    bound_ms, bound_by = classify_bound(name, inputs, counts)
    nb = counts["blocks"]
    device = inputs[1].device
    flush = torch.zeros(L2_FLUSH_INTS, dtype=torch.int32, device=device)
    if name == "classify_pass1":
        origins, scal, pyramid, geom, cap = inputs
        call = lambda: cb.classify_pass1(origins, scal, pyramid, geom, cap)  # noqa: E731
        plain = lambda: cb.classify_pass1_plain(origins, scal, pyramid, geom, cap)  # noqa: E731
        setup = flush.sum
        flags, classes = (torch.zeros((nb,), dtype=dtype, device=device)
                          for dtype in (torch.bool, torch.int32))
        glue = (lambda: cb.cap_candidates(classes, flags, cap)) if cap < nb else None
        shape = f"{nb} blocks, 2x2 cells, cap {cap}"
    else:
        before, origins, scal, pyramid, geom, cap, windows = inputs
        classes, plain_classes = before.clone(), before.clone()
        call = lambda: cb.classify_refine(classes, origins, scal, pyramid,  # noqa: E731
                                          geom, cap, windows)
        # The plain version's work does not depend on the classes' values.
        plain = lambda: cb.classify_refine_plain(plain_classes, origins, scal,  # noqa: E731
                                                 pyramid, geom, cap, windows)
        def setup():
            classes.copy_(before)
            flush.sum()

        glue = lambda: cb.band_rank(before)  # noqa: E731
        shape = (f"{nb} blocks ({counts['band']} BAND), 5x5 cells, cap {cap}, "
                 f"{'with' if windows else 'no'} windows; each launch on the classes as "
                 "before the call")
    shape += ", L2 flushed"
    ms, _ = device_profile(call, reps=20, warmup=3, setup=setup, kernel=f"{name}_kernel")
    if name == "classify_refine":
        want = before.clone()
        cb.classify_refine_plain(want, origins, scal, pyramid, geom, cap, windows)
        exact_or_raise("classify_refine (the classes after its timed launches)",
                       [(classes, want)])
    return dict(
        ms=ms, glue_ms=0.0 if glue is None else device_time_ms(glue, reps=20),
        plain_ms=device_time_ms(plain, reps=5, warmup=1), loop_ms=events_ms(call, reps=20),
        library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
        **{k: counts[k] for k in CLASSIFY_COUNTS}, shape=shape)


def sampler_bound(frame, vc, uc):
    """The sampler's least time on these coordinates. Bytes: v, u in and the
    word out per voxel, plus each distinct frame word once. Operations per
    voxel: two clamps (4), the flat index (2)."""
    flat = vc.long() * frame.shape[1] + uc.long()
    n = vc.numel()
    return bound(n * 12 + torch.unique(flat).numel() * 4, n * 6)


def max_abs_err(got, want) -> torch.Tensor:
    """Largest |got - want| on the card; equal values (equal infinities
    included) count 0, so it stays finite when the two agree."""
    g, w = got.double(), want.double()
    return torch.where(g == w, 0.0, (g - w).abs()).max()


def bit_differences(got, want) -> torch.Tensor:
    """How many elements differ in their bit patterns, on the card."""
    def bits(x):
        if x.dtype in (torch.float32, torch.bfloat16):
            return x.view(torch.int32 if x.dtype == torch.float32 else torch.int16)
        return x.to(torch.int32)
    return (bits(got) != bits(want)).sum()


def time_sampler(frame, vc, uc):
    """Kernel, plain, ``torch.take`` and launch-loop times of one sampler
    call, and its bound."""
    from hive_tpu_torch.ops import band_sampler as bs

    flat = (vc.long() * frame.shape[1] + uc.long()).contiguous()
    frame_flat = frame.reshape(-1)
    bound_ms, bound_by = sampler_bound(frame, vc, uc)
    return dict(
        ms=device_time_ms(lambda: bs.band_sample(frame, vc, uc), reps=200),
        plain_ms=device_time_ms(lambda: bs.band_sample_plain(frame, vc, uc), reps=200),
        loop_ms=events_ms(lambda: bs.band_sample(frame, vc, uc), reps=200),
        library_ms=device_time_ms(lambda: torch.take(frame_flat, flat), reps=200),
        bound_ms=bound_ms, bound_by=bound_by,
        shape=f"frame {tuple(frame.shape)} int32, coordinates {tuple(vc.shape)} int32")


# Operations per voxel of the band update (csrc/band_update.cu), each f32 or
# integer instruction-level operation counted once (a division as one): for
# every voxel, in-slab offsets 7, camera coordinates 18 (3 x (3 mul, 3 add)),
# z guard 2, u and v 10 (2 x (mul, div, add, round, convert)), view test 5;
# for a voxel in view, clamps and address 6 and the unpack, 15 (rgb565d16)
# or 8 (rgb888), keyed by the frame words per pixel; for a valid voxel, the
# update 31 (sdf, 3 tests, scale and clamp, 5 for the weights, 4 x
# (convert, mul, FMA, div, convert) for tsdf and the colours).
BAND_UPDATE_OPS = dict(voxel=42, in_view={1: 21, 2: 14}, valid=31)
# What the band update's bound counts, reported beside its times.
BAND_UPDATE_COUNTS = ("voxels", "in_view", "valid", "values_changed")
# Rows per trip where the band update's plain version runs on the card.
PLAIN_TRIP_ROWS = 4096
# An L2 flush: reading twice the H100's 50 MB L2 evicts what a setup left
# there (and leaves clean lines, so no write-back lands in the timed call).
L2_FLUSH_INTS = 25 << 20


def band_update_in_trips(state, ids, base, scal, frames, *, block, sub):
    """The band update's plain version in trips of PLAIN_TRIP_ROWS rows,
    which bounds its temporaries on the card."""
    from hive_tpu_torch.ops.band_update import band_update_plain

    for start in range(0, ids.numel(), PLAIN_TRIP_ROWS):
        end = start + PLAIN_TRIP_ROWS
        band_update_plain(state, ids[start:end], base[start:end], scal, frames, block=block,
                          sub=sub)


def band_call(volume, frames, f: int, device, slab=None) -> dict:
    """The band update's inputs for frame ``f`` on ``volume`` (or on one
    ``slab`` of its split rows), built by its integrator's stages as
    ``integrate_frame`` builds them (weight 1)."""
    from hive_tpu_torch.ops.tsdf_sparse import build_flat_pyramid

    depths, colors, K, poses = frames
    height, width = depths.shape[1:]
    if slab is None:
        integ = volume._integrator(height, width, None)
        origins, state = volume.block_origins_device, volume.state
    else:
        integ = volume._integrator(height, width, None, slab.origins.shape[0], slab.device)
        origins, state = slab.origins, slab.state
    w2c = torch.linalg.inv(torch.as_tensor(poses[f], device=device))
    R, t = w2c[:3, :3], w2c[:3, 3]
    intr = torch.tensor([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], device=device)
    one = torch.tensor(1.0, device=device)
    sample = integ.pack_frame(depths[f], colors[f])
    pyramid = build_flat_pyramid(depths[f], height, width,
                                 packed_u16=volume.color_mode == "rgb565d16")
    classes, dmin, dmax, free_ok = integ.classify_refined(origins, pyramid, R, t, tuple(intr))
    band_flat, _, _ = integ.slab_masks(origins, classes, dmin, dmax, free_ok, R, t, one)
    ids = torch.nonzero(band_flat).reshape(-1)
    return dict(state=integ.to_slabs(state), ids=ids,
                base=integ.slab_base(origins, ids, R, t), scal=integ.band_scalars(intr, R, one),
                frames=sample, block=integ.block, sub=integ.SUB)


def compact_call(call: dict) -> dict:
    """The same band update on a copy of just its rows: ids 0..K-1 and the
    SUB = 1 colour layout (each row's R|G|B segments), which give every
    voxel the same inputs and so the same result."""
    from hive_tpu_torch.ops.band_update import gather_rows

    tsdf, weight, color = gather_rows(call["state"], call["ids"], call["sub"])
    n = tsdf.shape[0]
    return dict(call, state=(tsdf, weight, color.reshape(n * 3, -1)),
                ids=torch.arange(n, device=tsdf.device), sub=1)


def band_update_args(call: dict):
    return ((call["ids"], call["base"], call["scal"], call["frames"]),
            dict(block=call["block"], sub=call["sub"]))


def band_update_exact(call: dict) -> float:
    """The kernel on ``call``'s state in place vs the plain version on a
    copy: every value bit for bit. Returns the largest |difference| (0)."""
    from hive_tpu_torch.ops import band_update as bu

    args, options = band_update_args(call)
    want = tuple(x.clone() for x in call["state"])
    bu.band_update_plain(want, *args, **options)
    bu.band_update(call["state"], *args, **options)
    return exact_or_raise("band_update", zip(call["state"], want))


def band_update_bound(compact: dict, after):
    """The band update's least time on this call (``compact``: its rows
    before the update, as :func:`compact_call` gives them; ``after``: the
    plain version's result). Whether a voxel is updated depends only on its
    geometry and the frame, so the function reads the state of the valid
    voxels only. Bytes: those voxels' 5 values read once, each value that
    changes written once, the id and base of each row, the 64 B of scalars,
    and each distinct frame word that a voxel in view samples once."""
    from hive_tpu_torch.ops import band_update as bu

    before, frames = compact["state"], compact["frames"]
    n, bvs = before[0].shape
    elem = before[0].element_size()
    changed = sum(int(bit_differences(a, b)) for a, b in zip(after, before))
    pixel, in_view, valid, _, _ = bu.observe(compact["base"], compact["scal"], frames,
                                             block=compact["block"], bvs=bvs)
    seen, updated = int(in_view.sum()), int(valid.sum())
    pixels = torch.unique(pixel[in_view]).numel()
    ops = (n * bvs * BAND_UPDATE_OPS["voxel"] + seen * BAND_UPDATE_OPS["in_view"][len(frames)]
           + updated * BAND_UPDATE_OPS["valid"])
    bound_ms, bound_by = bound(updated * 5 * elem + changed * elem + n * 20 + 64
                               + pixels * 4 * len(frames), ops)
    return bound_ms, bound_by, dict(zip(BAND_UPDATE_COUNTS, (n * bvs, seen, updated, changed)))


def time_band_update(call: dict, compact: dict, tag: str) -> dict:
    """Kernel and plain times of one band update, and its bound.

    ``call`` is the update on its own state (scattered slab ids, the
    integrator's layout), ``compact`` its rows before the update. Each timed
    launch runs on ``call``'s state after its rows were written back from
    ``compact`` and the L2 flushed, so every launch makes the whole update
    from a cold cache; the state after the last launch must equal one update
    by the plain version, bit for bit. The plain version's work does not
    depend on the state's values, so it runs again and again on one copy."""
    from hive_tpu_torch.ops import band_update as bu

    args, options = band_update_args(call)
    compact_args, compact_options = band_update_args(compact)
    after = tuple(x.clone() for x in compact["state"])
    bu.band_update_plain(after, *compact_args, **compact_options)
    bound_ms, bound_by, counts = band_update_bound(compact, after)
    n, bvs = compact["state"][0].shape
    before = (*compact["state"][:2], compact["state"][2].view(n, 3, bvs))
    flush = torch.zeros(L2_FLUSH_INTS, dtype=torch.int32, device=call["ids"].device)

    def setup():
        bu.scatter_rows(call["state"], call["ids"], call["sub"], before)
        flush.sum()

    def launch():
        bu.band_update(call["state"], *args, **options)

    ms, _ = device_profile(launch, reps=10, warmup=2, setup=setup, kernel="band_update_kernel")
    tsdf, weight, color = bu.gather_rows(call["state"], call["ids"], call["sub"])
    exact_or_raise("band_update (the state after its timed launches)",
                   zip((tsdf, weight, color.reshape(n * 3, bvs)), after))
    plain_state = tuple(x.clone() for x in compact["state"])
    times = dict(
        ms=ms, loop_ms=None, library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
        plain_ms=device_time_ms(lambda: bu.band_update_plain(plain_state, *compact_args,
                                                             **compact_options),
                                reps=3, warmup=1),
        **counts,
        shape=f"{n} slab rows x {bvs} voxels, {compact['state'][0].dtype} state, "
              f"{len(call['frames'])} frame word(s) per pixel; each launch on the rows as "
              "before the update, L2 flushed")
    log_times(tag, times)
    log(f"[{tag}] {counts['voxels']} voxels, {counts['in_view']} in view, {counts['valid']} "
        f"valid; {counts['values_changed']} values changed (every timed launch: the state "
        f"after them equals one update)")
    return times


def log_times(tag: str, times: dict) -> None:
    library = ("" if times["library_ms"] is None
               else f" {times.get('library', 'take')}={times['library_ms']:.6f} ms")
    loop = ("" if times["loop_ms"] is None
            else f"; launch loop {times['loop_ms']:.6f} ms/call (events)")
    log(f"[{tag}] {times['shape']}: kernel={times['ms']:.6f} ms "
        f"plain={times['plain_ms']:.6f} ms{library} (profiler){loop}; "
        f"bound={times['bound_ms']:.7f} ms ({times['bound_by']})")


def video_tools() -> dict:
    """Where ``ffmpeg`` and ``ffprobe`` are on PATH, with the first line of
    their ``-version`` (None if absent): the video inputs need a decoder."""
    found = {}
    for name in ("ffmpeg", "ffprobe"):
        path = shutil.which(name)
        if path is None:
            found[name] = None
            continue
        done = subprocess.run([path, "-version"], capture_output=True, text=True, timeout=60)
        found[name] = f"{path}: {(done.stdout.splitlines() or [''])[0]}"
    return found


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Scenes.
# ---------------------------------------------------------------------------

def bench_frames(device):
    """The TSDF bench's wavy wall 1.5-3.5 m away, textured, made on the card."""
    f = torch.arange(BENCH_FRAMES, device=device, dtype=torch.float32)[:, None, None]
    v = torch.arange(BENCH_H, device=device, dtype=torch.float32)[None, :, None]
    u = torch.arange(BENCH_W, device=device, dtype=torch.float32)[None, None, :]
    depths = 2.5 + 0.3 * torch.sin(u * 0.02 + f * 0.3) * torch.cos(v * 0.03)
    shape = (BENCH_FRAMES, BENCH_H, BENCH_W)
    colors = torch.stack([((u * 0.4) % 255.0).expand(shape),
                          ((v * 0.5) % 255.0).expand(shape),
                          ((u + v + 30.0 * f) % 255.0).expand(shape)], dim=-1)
    K = np.array([[580.0, 0, 319.5], [0, 580.0, 239.5], [0, 0, 1.0]], np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (BENCH_FRAMES, 1, 1))
    poses[:, 0, 3] = np.linspace(0.0, 0.5, BENCH_FRAMES) + 0.0123
    return depths.contiguous(), colors.contiguous(), K, poses


def write_png(path: str, image: np.ndarray) -> None:
    """Write an 8-bit grey/RGB or 16-bit grey PNG (filter 0) with zlib."""
    height, width = image.shape[:2]
    if image.dtype == np.uint16:
        depth, colour, raw = 16, 0, image.astype(">u2").tobytes()
    else:
        depth, colour = 8, (2 if image.ndim == 3 else 0)
        raw = np.ascontiguousarray(image, np.uint8).tobytes()
    stride = len(raw) // height
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride)
    body = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth, colour,
                                           0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(body, 1)))
        f.write(chunk(b"IEND", b""))


def write_hive_dataset(base: str, num_frames: int, width: int, height: int) -> None:
    """A synthetic HIVE-format dataset: a camera sliding sideways in front of a
    wall at z = 2 m (R = 60, G = x gradient, B = y gradient) with a moving
    masked blob at 1.5 m, and +-1 mm seeded sensor noise on the depth."""
    from hive_tpu_torch.options import COLMAPOptions

    rng = np.random.default_rng(SEED)
    for sub in ("rgb", "depth", "mask"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)

    fx = fy = 100.0
    cx, cy = (width - 1) / 2.0, (height - 1) / 2.0
    np.savetxt(os.path.join(base, "camera_matrix.txt"),
               np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]]))

    poses = np.zeros((num_frames, 7))
    poses[:, 3] = 1.0
    poses[:, 4] = -0.02 * np.arange(num_frames)
    np.savetxt(os.path.join(base, "camera_trajectory.txt"), poses)

    us, vs = np.meshgrid(np.arange(width), np.arange(height))
    for i in range(num_frames):
        rgb = np.zeros((height, width, 3), dtype=np.uint8)
        rgb[..., 0] = 60
        rgb[..., 1] = (us * 255 // width).astype(np.uint8)
        rgb[..., 2] = (vs * 255 // height).astype(np.uint8)
        depth_mm = 2000 + rng.integers(-1, 2, size=(height, width))
        mask = np.zeros((height, width), dtype=np.uint8)

        blob = (us - (width // 4 + i * 6)) ** 2 + (vs - height // 2) ** 2 \
            < (height // 5) ** 2
        depth_mm[blob] = 1500
        mask[blob] = 1
        rgb[blob] = [200, 64, 64]

        name = f"{i:06d}.png"
        write_png(os.path.join(base, "rgb", name), rgb)
        write_png(os.path.join(base, "depth", name), depth_mm.astype(np.uint16))
        write_png(os.path.join(base, "mask", name), mask)

    metadata = dict(num_frames=num_frames, fps=30.0, frame_step=1, width=width,
                    height=height, depth_scale=1.0 / 1000.0, max_depth=10.0,
                    depth_mask_dilation_iterations=10, estimate_pose=False,
                    estimate_depth=False, colmap_options=COLMAPOptions().to_json())
    with open(os.path.join(base, "metadata.json"), "w") as f:
        json.dump(metadata, f)


# ---------------------------------------------------------------------------
# Phases.
# ---------------------------------------------------------------------------

def plain_paths():
    """Patch the integrator onto the kernels' plain versions (on the card)."""
    from hive_tpu_torch.ops import classify_blocks as cb
    from hive_tpu_torch.ops import tsdf_sparse

    return (mock.patch.object(tsdf_sparse, "band_update", band_update_in_trips),
            mock.patch.object(tsdf_sparse, "classify_pass1", cb.classify_pass1_plain),
            mock.patch.object(tsdf_sparse, "classify_refine", cb.classify_refine_plain))


def reset_launch_counts() -> None:
    """The main path's kernels' launch counts to 0: the classification, the
    band update, and the SIFT histograms' ordered sum (PnP pose, MIFD)."""
    from hive_tpu_torch.ops import band_update, ordered_hist
    from hive_tpu_torch.ops import classify_blocks as cb

    band_update.launches = cb.pass1_launches = cb.refine_launches = 0
    ordered_hist.launches = 0


def main_launch_counts() -> dict:
    from hive_tpu_torch.ops import band_update, ordered_hist
    from hive_tpu_torch.ops import classify_blocks as cb

    return {"band_update": band_update.launches, "classify_pass1": cb.pass1_launches,
            "classify_refine": cb.refine_launches, "ordered_hist": ordered_hist.launches}


def without_bg_quantize():
    """A patch of ``Pipeline._compress_mesh`` that leaves ``bg.glb``
    unquantized (the foreground's meshes are compressed as usual): the e2e
    and video CLI runs take it for the script's time limit."""
    from hive_tpu_torch.pipeline import Pipeline

    compress = Pipeline._compress_mesh

    def compress_foreground(self, path):
        if os.path.basename(path) != "bg.glb":
            compress(self, path)

    return mock.patch.object(Pipeline, "_compress_mesh", compress_foreground)


def check_launches(path: str, counts: dict, frames: int, shards: int = 1) -> None:
    """Exactly one launch of each classification pass per frame and shard
    of the volume's rows, and the band update launched (once per frame and
    shard with a band)."""
    launches = frames * shards
    if (counts["classify_pass1"], counts["classify_refine"]) != (launches, launches) or not (
            0 < counts["band_update"] <= launches):
        raise AssertionError(f"{path} launched {counts} in {frames} frames over {shards} "
                             f"shard(s)")


def classify_exact(origins, scal, pyramid, geom, cap: int, refine_cap: int, windows: bool):
    """Both passes on one frame, each kernel vs its plain version: classes
    and windows bit for bit. Returns (pass-1 inputs, refine inputs, the
    largest |difference|, the classes the refine pass changed)."""
    from hive_tpu_torch.ops import classify_blocks as cb

    classes = cb.classify_pass1(origins, scal, pyramid, geom, cap)
    err = exact_or_raise("classify_pass1", [
        (classes, cb.classify_pass1_plain(origins, scal, pyramid, geom, cap))])
    before, want = classes.clone(), classes.clone()
    got_windows = cb.classify_refine(classes, origins, scal, pyramid, geom, refine_cap, windows)
    want_windows = cb.classify_refine_plain(want, origins, scal, pyramid, geom, refine_cap,
                                            windows)
    err = max(err, exact_or_raise("classify_refine", [(classes, want)] + [
        (g, w) for g, w in zip(got_windows, want_windows) if g is not None]))
    return ((origins, scal, pyramid, geom, cap),
            (before, origins, scal, pyramid, geom, refine_cap, windows), err,
            int((classes != before).sum()))


def check_classify(device, frames):
    """Both classification passes bit-exact against the plain version on
    bench frame 0 with 10% of its depth pixels invalid, without compaction,
    with the 0.375 cap and with a cap that overflows, and on a SUB = 2
    small volume (a slanted wavy surface) with windows; timed at the bench
    shape with the cap ``integrate_frames`` picks there."""
    from hive_tpu_torch.ops import classify_blocks as cb
    from hive_tpu_torch.ops.tsdf_sparse import (SparseTSDFVolume, build_flat_pyramid,
                                                pick_compact_cap)

    depths, _, K, poses = frames
    rng = np.random.default_rng(SEED)
    depth = depths[0].clone()
    depth[torch.as_tensor(rng.random((BENCH_H, BENCH_W)) < 0.1, device=device)] = 0.0
    volume = SparseTSDFVolume([[-2.0, 2.0], [-2.0, 2.0], [0.0, 4.0]],
                              voxel_size=4.0 / BENCH_GRID, device=device)
    w2c = torch.linalg.inv(torch.as_tensor(poses[0], device=device))
    intr = torch.tensor([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], device=device)
    scal = cb.classify_scalars(w2c[:3, :3], w2c[:3, 3], intr)
    pyramid = build_flat_pyramid(depth, BENCH_H, BENCH_W, packed_u16=True)
    origins, nb = volume.block_origins_device, volume.num_blocks
    bench_level = pick_compact_cap(volume.estimate_candidate_fraction(K, poses, BENCH_H,
                                                                      BENCH_W))
    checked, err, timed = [], 0.0, None
    for level in dict.fromkeys((None, 0.375, 0.01, bench_level)):
        integ = volume._integrator(BENCH_H, BENCH_W, level)
        cap = integ.pass1_cap
        p1, rf, e, changed = classify_exact(origins, scal, pyramid, integ.geometry, cap,
                                            integ.refine_cap, integ.SUB > 1)
        err = max(err, e)
        checked.append(f"cap {cap} ({changed} refined classes changed)")
        if level == bench_level:
            timed = (p1, rf)

    h, w = 96, 128
    small = SparseTSDFVolume([[-1.6, 1.6], [-1.6, 1.6], [0.0, 3.2]], voxel_size=0.025,
                             block_size=(8, 8, 16), device=device)
    # A wavy slanted surface, its left 8 columns invalid.
    u = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    v = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    small_depth = 1.2 + 1.5 * u / w + 0.2 * torch.sin(v * 0.2)
    small_depth[:, :8] = 0.0
    small_scal = cb.classify_scalars(torch.eye(3, device=device),
                                     torch.tensor([-0.01237, 0.0, 0.0], device=device),
                                     torch.tensor([100.0, 100.0, 63.5, 47.5], device=device))
    small_pyramid = build_flat_pyramid(small_depth, h, w, packed_u16=True)
    for level in (None, 0.375):
        integ = small._integrator(h, w, level)
        if integ.SUB != 2:
            raise AssertionError(f"the small volume's blocks give SUB = {integ.SUB}")
        cap = integ.pass1_cap
        _, _, e, changed = classify_exact(small.block_origins_device, small_scal, small_pyramid,
                                          integ.geometry, cap, integ.refine_cap, True)
        err = max(err, e)
        checked.append(f"SUB = 2 cap {cap} ({changed} refined classes changed)")
    log(f"[classify] both passes bit-exact at the bench shape ({nb} blocks) and on a SUB = 2 "
        f"small volume ({small.num_blocks} blocks, windows): " + ", ".join(checked))

    out = {}
    for name, inputs in zip(("classify_pass1", "classify_refine"), timed):
        times = time_classify(name, inputs)
        log_times(f"{name}, bench shape, exact", times)
        out[name] = dict(times, max_abs_err=err)
    return out


def check_sampler(device, frames):
    from hive_tpu_torch.ops import band_sampler as bs
    from hive_tpu_torch.ops.tsdf_sparse import SparseTSDFVolume, build_flat_pyramid

    depths, colors, K, poses = frames
    volume = SparseTSDFVolume([[-2.0, 2.0], [-2.0, 2.0], [0.0, 4.0]],
                              voxel_size=4.0 / BENCH_GRID, device=device)
    integ = volume._integrator(BENCH_H, BENCH_W, None)
    w2c = torch.linalg.inv(torch.as_tensor(poses[0], device=device))
    R, t = w2c[:3, :3], w2c[:3, 3]
    intr = tuple(torch.tensor([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], device=device))
    origins = volume.block_origins_device

    (packed,) = integ.pack_frame(depths[0], colors[0])
    pyramid = build_flat_pyramid(depths[0], BENCH_H, BENCH_W, packed_u16=True)
    classes, dmin, dmax, free_ok = integ.classify_refined(origins, pyramid, R, t, intr)
    band_flat, _, _ = integ.slab_masks(origins, classes, dmin, dmax, free_ok, R, t,
                                       torch.tensor(1.0, device=device))
    band_ids = torch.nonzero(band_flat).reshape(-1)

    def coords(ids):
        cam_x, cam_y, cam_z = integ.slab_camera_coords(origins, ids, R, t)
        u, v, _ = integ.project_voxels(cam_x, cam_y, cam_z, intr)
        return (torch.clamp(v, 0, BENCH_H - 1).contiguous(),
                torch.clamp(u, 0, BENCH_W - 1).contiguous())

    vc_all, uc_all = coords(band_ids)
    vc, uc = coords(band_ids[:integ.chunk])
    err = exact_or_raise("band_sampler", [
        (bs.band_sample(packed, vc_all, uc_all), bs.band_sample_plain(packed, vc_all, uc_all)),
        (bs.band_sample(packed, vc, uc), bs.band_sample_plain(packed, vc, uc))])

    times = time_sampler(packed, vc, uc)
    log_times(f"sampler, bench shape, one trip (frame band {band_ids.numel()} rows), exact "
              "on the trip and the frame's band", times)
    return dict(times, max_abs_err=err)


def check_band_update(device, frames):
    """The band update of frame 2 on the bench volume (f32) after two
    integrated frames: bit-exact on the frame's whole band, timed."""
    from hive_tpu_torch.ops.tsdf_sparse import SparseTSDFVolume

    depths, colors, K, poses = frames
    volume = SparseTSDFVolume([[-2.0, 2.0], [-2.0, 2.0], [0.0, 4.0]],
                              voxel_size=4.0 / BENCH_GRID, device=device)
    volume.integrate_frames(colors[:2], depths[:2], K, poses[:2])
    call = band_call(volume, frames, 2, device)
    compact = compact_call(call)
    err = band_update_exact(call)
    times = time_band_update(call, compact, f"band_update, bench shape (frame band "
                                            f"{call['ids'].numel()} rows), exact")
    return dict(times, max_abs_err=err)


def check_band_update_states(device):
    """The band update bit-exact in each state dtype and colour mode, at
    SUB = 1 and 2, on a small volume (random depth, 96 x 128): frame 2's
    band after two integrated frames."""
    from hive_tpu_torch.ops.tsdf_sparse import SparseTSDFVolume

    rng = np.random.default_rng(SEED)
    h, w = 96, 128
    K = np.array([[100.0, 0.0, 63.5], [0.0, 100.0, 47.5], [0.0, 0.0, 1.0]], np.float32)
    depths = torch.as_tensor(rng.uniform(0.8, 2.5, size=(3, h, w)), dtype=torch.float32,
                             device=device)
    colors = torch.as_tensor(rng.integers(0, 255, size=(3, h, w, 3)), dtype=torch.uint8,
                             device=device)
    poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    poses[:, 0, 3] = np.linspace(0.0, 0.3, 3) + 0.01237
    bounds = np.array([[-1.6, 1.6], [-1.6, 1.6], [0.0, 3.2]], np.float32)
    checked = []
    for dtype in (torch.float32, torch.bfloat16):
        for mode in ("rgb565d16", "rgb888"):
            for block in ((8, 8, 8), (8, 8, 16)):
                volume = SparseTSDFVolume(bounds, voxel_size=0.05, color_mode=mode, dtype=dtype,
                                          block_size=block, device=device)
                volume.integrate_frames(colors[:2], depths[:2], K, poses[:2])
                call = band_call(volume, (depths, colors, K, poses), 2, device)
                band_update_exact(call)
                checked.append(f"{str(dtype)[6:]}/{mode}/SUB={call['sub']} "
                               f"({call['ids'].numel()} rows)")
    log(f"[band_update] bit-exact on a small volume in {len(checked)} states: "
        + ", ".join(checked))


def check_integration(device, frames, launches):
    from hive_tpu_torch.ops.tsdf_sparse import SparseTSDFVolume

    depths, colors, K, poses = frames
    bounds = np.array([[-2.0, 2.0], [-2.0, 2.0], [0.0, 4.0]], np.float32)

    def volume():
        return SparseTSDFVolume(bounds, voxel_size=4.0 / BENCH_GRID, device=device)

    reset_launch_counts()
    kernel_vol = volume()
    kernel_vol.integrate_frames(colors, depths, K, poses)
    torch.cuda.synchronize()
    launches["bench"] = main_launch_counts()

    plain_vol = volume()
    patches = plain_paths()
    with patches[0], patches[1], patches[2]:
        start = time.perf_counter()
        plain_vol.integrate_frames(colors, depths, K, poses)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - start

    for name in ("tsdf", "weight", "color"):
        if not torch.equal(getattr(kernel_vol.state, name), getattr(plain_vol.state, name)):
            raise AssertionError(f"kernel and plain integration differ in {name}")
    check_launches("bench integration", launches["bench"], BENCH_FRAMES)

    samples = []
    for _ in range(5):
        start = time.perf_counter()
        kernel_vol.integrate_frames(colors, depths, K, poses)
        torch.cuda.synchronize()
        samples.append(time.perf_counter() - start)
    median = sorted(samples)[len(samples) // 2]
    rate = kernel_vol.num_voxels * BENCH_FRAMES / median

    from torch.profiler import ProfilerActivity, profile

    start = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        kernel_vol.integrate_frames(colors, depths, K, poses)
        torch.cuda.synchronize()
    traced_s = time.perf_counter() - start
    busy_s = device_us(prof) / 1e6
    events = prof.key_averages()
    top = sorted(events, key=lambda e: -self_device_us(e))[:6]
    # torch.nonzero sizes the band and edge trip streams and the free pass on
    # the host: each call waits for the device (the .item()-class sync of the
    # trip counts). The classification makes none.
    ops = {key: [e for e in events if e.key == key]
           for key in ("aten::nonzero", "aten::add", "aten::mul", "aten::cumsum")}
    counts = {key: sum(e.count for e in found) for key, found in ops.items()}
    sync_ms = sum(e.cpu_time_total for e in ops["aten::nonzero"]) / 1e3
    log(f"[integrate] in the traced rep of {BENCH_FRAMES} frames: "
        + ", ".join(f"{key} x{n}" for key, n in counts.items())
        + f"; aten::nonzero {sync_ms:.1f} ms of host time including its device waits")
    log(f"[integrate] traced rep {traced_s * 1e3:.1f} ms, device busy "
        f"{busy_s * 1e3:.1f} ms ({100 * busy_s / traced_s:.1f}%; "
        f"{'not measured' if busy_s == 0 else 'profiler'}); top device time: "
        + "; ".join(f"{e.key[:40]} x{e.count} {self_device_us(e) / 1e3:.2f} ms"
                    for e in top))
    log(f"[integrate] VGA x {BENCH_FRAMES} frames into {kernel_vol.dims} "
        f"({kernel_vol.num_voxels} voxels): kernel == plain bit-identical; "
        f"launches {launches['bench']}; {rate / 1e6:.1f}M voxel-updates/s "
        f"(median of 5: {median * 1e3:.1f} ms; reps "
        f"{[round(s * 1e3, 1) for s in samples]} ms); plain path "
        f"{plain_s * 1e3:.1f} ms")
    return rate


def check_sparse_vs_dense(device):
    """The JAX package's sparse-vs-dense self-check (random depth, 3 frames,
    rgb888) on the card: at most 1e-3 of voxels may differ."""
    from hive_tpu_torch.ops.tsdf import TSDFVolume
    from hive_tpu_torch.ops.tsdf_sparse import SparseTSDFVolume

    rng = np.random.default_rng(SEED)
    h, w = 96, 128
    K = np.array([[100.0, 0.0, 63.5], [0.0, 100.0, 47.5], [0.0, 0.0, 1.0]], np.float32)
    depths = rng.uniform(0.8, 2.5, size=(3, h, w)).astype(np.float32)
    colors = rng.integers(0, 255, size=(3, h, w, 3)).astype(np.uint8)
    poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    poses[:, 0, 3] = np.linspace(0.0, 0.3, 3) + 0.01237
    poses[:, 1, 3] = 0.00731
    bounds = np.array([[-1.6, 1.6], [-1.6, 1.6], [0.0, 3.2]], np.float32)

    dense = TSDFVolume(bounds, voxel_size=0.05, device=device)
    dense.integrate_frames(colors, depths, K, poses)
    sparse = SparseTSDFVolume(bounds, voxel_size=0.05, color_mode="rgb888", device=device)
    sparse.integrate_frames(colors, depths, K, poses)
    tsdf_d, w_d, _ = dense.get_volume()
    tsdf_s, w_s, _ = sparse.get_volume()
    w_frac = float((np.abs(w_s - w_d) > 1e-5).mean())
    t_frac = float((np.abs(tsdf_s - tsdf_d) > 1e-4).mean())
    if w_frac >= 1e-3 or t_frac >= 2e-3:
        raise AssertionError(f"sparse vs dense: weight {w_frac}, tsdf {t_frac} differ")
    log(f"[self-check] sparse vs dense on {sparse.dims}: weight differs at "
        f"{w_frac:.2e}, tsdf at {t_frac:.2e} of voxels")


class MainPathCheck:
    """Stands in for the integrator's kernel calls during the CLI run.

    Each call goes through the kernel's own wrapper (which counts the
    launch) and, on the same inputs, through its plain version (no launch):
    the classification's two passes on the same tensors (the refine pass on
    a copy of the classes it updates in place), the band update on a
    snapshot of the frame's band rows taken before the kernel updates them
    in place. The bit differences and the largest |difference| add up on
    the card, so the check adds no host sync; the calls' inputs are kept
    (the band update's largest only) so the kernels are timed at the main
    path's own shapes afterwards."""

    NAMES = ("classify_pass1", "classify_refine", "band_update")

    def __init__(self, device):
        self.differences = {n: torch.zeros((), dtype=torch.int64, device=device)
                            for n in self.NAMES}
        self.max_abs_err = {n: torch.zeros((), dtype=torch.float64, device=device)
                            for n in self.NAMES}
        self.calls = dict.fromkeys(self.NAMES, 0)
        self.kept = {n: [] for n in self.NAMES}

    def _compare(self, name, got, want):
        for g, w in zip(got, want):
            self.differences[name] += bit_differences(g, w)
            self.max_abs_err[name] = torch.maximum(self.max_abs_err[name],
                                                   max_abs_err(g, w))
        self.calls[name] += 1

    def pass1(self, origins, scal, pyramid, geom, cap):
        from hive_tpu_torch.ops import classify_blocks as cb

        got = cb.classify_pass1(origins, scal, pyramid, geom, cap)
        self._compare("classify_pass1", [got],
                      [cb.classify_pass1_plain(origins, scal, pyramid, geom, cap)])
        # The volume's origins stay as they are; the frame's scalars and
        # pyramid are copied.
        self.kept["classify_pass1"].append((origins, scal.clone(), pyramid.clone(), geom, cap))
        return got

    def refine(self, classes, origins, scal, pyramid, geom, cap, windows):
        from hive_tpu_torch.ops import classify_blocks as cb

        before, want = classes.clone(), classes.clone()
        got = cb.classify_refine(classes, origins, scal, pyramid, geom, cap, windows)
        want_windows = cb.classify_refine_plain(want, origins, scal, pyramid, geom, cap,
                                                windows)
        self._compare("classify_refine", [classes, *(g for g in got if g is not None)],
                      [want, *(w for w in want_windows if w is not None)])
        self.kept["classify_refine"].append((before, origins, scal.clone(), pyramid.clone(),
                                             geom, cap, windows))
        return got

    def update(self, state, ids, base, scal, frames, *, block, sub):
        from hive_tpu_torch.ops import band_update as bu

        call = dict(state=state, ids=ids, base=base, scal=scal, frames=frames, block=block,
                    sub=sub)
        before = compact_call(call)
        want = tuple(x.clone() for x in before["state"])
        bu.band_update(state, ids, base, scal, frames, block=block, sub=sub)
        band_update_in_trips(want, before["ids"], base, scal, frames, block=block, sub=1)
        tsdf, weight, color = bu.gather_rows(state, ids, sub)
        got = (tsdf, weight, color.reshape(tsdf.shape[0] * 3, -1))
        self._compare("band_update", got, want)
        # The snapshot, ids, bases, scalars and packed frames are this call's
        # own; the state is the volume's, which stays alive with them.
        kept = self.kept["band_update"]
        if not kept or ids.numel() > kept[0][0]["ids"].numel():
            kept[:] = [(call, before)]

    def results(self):
        """Per kernel: calls checked, bit differences, largest |difference|,
        and the times at the largest call's inputs (the classification's:
        the frame with the most blocks that read the pyramid)."""
        out = {}
        for name in self.NAMES:
            differences = int(self.differences[name])
            if self.calls[name] == 0 or differences:
                raise AssertionError(f"{name} on the main path: {self.calls[name]} calls "
                                     f"checked, {differences} values differ from plain")
            tag = f"{name}, main path's largest call, exact in {self.calls[name]} calls"
            if name == "band_update":
                times = time_band_update(*self.kept[name][0], tag)
            else:
                inputs = max(self.kept[name], key=lambda x: classify_counts(name, x)["reads"])
                times = time_classify(name, inputs)
                log_times(tag, times)
            out[name] = dict(times, calls_checked=self.calls[name],
                             max_abs_err=float(self.max_abs_err[name]))
        return out


def host_ms(fn, reps: int = 3) -> float:
    start = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - start) / reps * 1e3


def time_decoders(dataset: str) -> dict:
    """Host ms of the port's frame decoders on one e2e frame: the PNG as
    this script writes it (filter 0) and re-encoded with per-row adaptive
    filters, as Pillow, OpenCV and TUM write PNGs; and the frame as a
    quality-75 4:2:0 JPEG, as hive_tpu converts frames. Adaptive PNGs and
    JPEGs decode natively by default; the plain versions are numpy and a
    Python symbol loop."""
    from hive_tpu_torch.image_codecs import decode_jpeg, encode_jpeg, encode_png
    from hive_tpu_torch.io import decode_png

    with open(os.path.join(dataset, "rgb", "000000.png"), "rb") as f:
        plain = f.read()
    image = decode_png(plain)
    adaptive, jpeg = encode_png(image), encode_jpeg(image, quality=75)
    if not (np.array_equal(decode_png(adaptive, native=True), image)
            and np.array_equal(decode_png(adaptive, native=False), image)
            and np.array_equal(decode_jpeg(jpeg, native=True), decode_jpeg(jpeg, native=False))):
        raise AssertionError("a native frame decoder disagrees with its plain version")
    times = {"png filter 0": host_ms(lambda: decode_png(plain)),
             "png adaptive native": host_ms(lambda: decode_png(adaptive, native=True)),
             "png adaptive plain": host_ms(lambda: decode_png(adaptive, native=False)),
             "jpeg q75 native": host_ms(lambda: decode_jpeg(jpeg, native=True)),
             "jpeg q75 plain": host_ms(lambda: decode_jpeg(jpeg, native=False), reps=1)}
    log(f"[io] host decode of one {E2E_W}x{E2E_H} RGB frame ({len(jpeg)} B as JPEG): "
        + ", ".join(f"{name} {ms:.2f} ms" for name, ms in times.items()))
    return times


FOREGROUND_STAGES = ("binary_mask_creation", "per_object_mesh", "face_filtering",
                     "mesh_decimation", "floater_removal", "billboard", "texturing",
                     "texture_atlas_packing")


def check_foreground(foreground, background_mesh, profiling) -> None:
    """The e2e run's fg.glb and its profiling: one textured mesh per frame
    with the blob's colour, in front of the wall; the foreground roll-ups;
    native QEM decimation; both parts compressed by quantization."""
    from hive_tpu_torch import native

    names = [f"{i:06d}" for i in range(E2E_FRAMES)]
    if foreground.node_names != names:
        raise AssertionError(f"fg.glb nodes {foreground.node_names}, want {names[0]}-{names[-1]}")
    for name in names:
        mesh = foreground.geometry[name]
        if mesh.num_faces == 0 or mesh.texture is None or mesh.uv is None:
            raise AssertionError(f"fg.glb frame {name}: no textured faces")
        if not np.isfinite(mesh.vertices).all() or mesh.uv.min() < 0.0 or mesh.uv.max() > 1.0:
            raise AssertionError(f"fg.glb frame {name}: vertices not finite or UVs outside "
                                 f"[0, 1] ({mesh.uv.min()}, {mesh.uv.max()})")
        median = np.median(mesh.texture.reshape(-1, 3), axis=0)
        if np.abs(median - (200, 64, 64)).max() > 2:
            raise AssertionError(f"fg.glb frame {name}: median texel {median}, "
                                 f"want (200, 64, 64) +- 2")
    # After the upright flip and centring the wall lies at the largest z and
    # the blob 0.5 m nearer the camera.
    gap = float(background_mesh.bounds[1][2] - foreground.geometry[names[0]].bounds[1][2])
    if not 0.2 < gap < 0.8:
        raise AssertionError(f"the blob sits {gap:.3f} m in front of the wall, want 0.2-0.8")

    timing = profiling["timing"]["foreground_reconstruction"]
    rollups = {stage: timing[stage] for stage in FOREGROUND_STAGES}
    rollups["per_object_mesh"] = rollups["per_object_mesh"]["total"]
    rollups["face_triangulation"] = timing["per_object_mesh"]["face_triangulation"]
    for stage, rollup in rollups.items():
        if set(rollup) != {"count", "total", "mean"} or rollup["count"] < E2E_FRAMES:
            raise AssertionError(f"foreground roll-up {stage}: {rollup}")
    faces = profiling["mesh_decimation"]["face_count"]
    lib = native.get_native_lib()
    if lib is None or not faces["after"]["total"] * 10 < faces["before"]["total"]:
        raise AssertionError(f"decimation: native library {lib}, faces {faces}")
    stats = profiling["mesh_compression"].get("foreground", {})
    if stats.get("method") != "quantization" or not (
            stats["compressed_file_size"] < stats["uncompressed_file_size"]):
        raise AssertionError(f"foreground mesh not compressed by quantization: {stats}")

    sizes = profiling["file_size"]["foreground"]
    log(f"[e2e] fg.glb {len(names)} textured frames, blob {gap:.4f} m in front of the wall; "
        f"faces per frame {faces['before']['mean']:.1f} before decimation, "
        f"{faces['after']['mean']:.1f} after (native QEM); fg.glb {sizes['total']} B, "
        f"{sizes['per_frame']} B per frame, quantized from "
        f"{profiling['mesh_compression']['foreground']['uncompressed_file_size']} B")
    log(f"[e2e] foreground stage {timing['total']:.4f} s beside the background stage "
        f"{profiling['timing']['background_reconstruction']['total']:.4f} s (overlapped: "
        f"{profiling['timing']['stages_overlapped']}); sub-stages, total / mean per object (s): "
        + ", ".join(f"{stage} {r['total']:.4f} / {r['mean']:.6f}" for stage, r in rollups.items()))


def run_main_path(device, launches, keep: str):
    """Phase 6; the dataset folder, with its meshes, is moved to ``keep``
    for the [eval] phase."""
    from hive_tpu_torch.meshing.gltf import load_glb
    from hive_tpu_torch.ops import tsdf_sparse

    check = MainPathCheck(device)

    # The 284 MB bg.glb's host quantize took 48.7-60.4 s of this run on the
    # H100 machines' hosts: it is left out here, so this run's
    # elapsed_time.per_frame leaves it out, its mesh_compression background
    # time is of nothing, and [eval] renders the unquantized bg.glb. The TUM
    # and [research] runs quantize theirs.
    with tempfile.TemporaryDirectory(prefix="hive_smoke_") as tmp:
        dataset = os.path.join(tmp, "synthetic")
        start = time.perf_counter()
        write_hive_dataset(dataset, E2E_FRAMES, E2E_W, E2E_H)
        log(f"[e2e] wrote {E2E_FRAMES} frames of {E2E_W}x{E2E_H} in "
            f"{time.perf_counter() - start:.1f} s")
        time_decoders(dataset)

        argv = ["hive_tpu_torch", "--dataset_path", dataset, "--output_path", dataset,
                "--num_frames", str(E2E_FRAMES), "--key_frame_threshold", "1.0", "--overwrite_ok",
                "--webxr_path", os.path.join(tmp, "webxr"),
                "--log_file", os.path.join(tmp, "pipeline.log")]
        reset_launch_counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        with mock.patch.object(sys, "argv", argv), \
                mock.patch.object(tsdf_sparse, "classify_pass1", check.pass1), \
                mock.patch.object(tsdf_sparse, "classify_refine", check.refine), \
                mock.patch.object(tsdf_sparse, "band_update", check.update), \
                without_bg_quantize():
            runpy.run_module("hive_tpu_torch", run_name="__main__", alter_sys=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        launches["main"] = main_launch_counts()

        with open(os.path.join(dataset, "profiling.json")) as f:
            profiling = json.load(f)
        scene = load_glb(os.path.join(dataset, "mesh", "bg.glb"))
        foreground = load_glb(os.path.join(dataset, "mesh", "fg.glb"))
        mesh = next(iter(scene.geometry.values()))
        verts, cols = mesh.vertices, mesh.vertex_colors
        shutil.move(dataset, keep)

    if len(verts) == 0 or not np.isfinite(verts).all():
        raise AssertionError("bg.glb holds no (finite) vertices")
    corr_x = float(np.corrcoef(verts[:, 0], cols[:, 1].astype(np.float64))[0, 1])
    corr_y = float(np.corrcoef(verts[:, 1], cols[:, 2].astype(np.float64))[0, 1])
    if abs(corr_x) < 0.9 or abs(corr_y) < 0.9:
        raise AssertionError(f"bg.glb colour gradients lost: corr(x, G) {corr_x:.3f}, "
                             f"corr(y, B) {corr_y:.3f}")
    check_launches("the main path", launches["main"], E2E_FRAMES)
    check_foreground(foreground, mesh, profiling)

    def rounded(tree):
        return {k: rounded(v) if isinstance(v, dict) else round(v, 4)
                for k, v in tree.items() if not isinstance(v, bool)}

    volume = profiling["background_volume"]
    log(f"[e2e] bg.glb {len(verts)} vertices, corr(x, G) {corr_x:.4f}, "
        f"corr(y, B) {corr_y:.4f}")
    log(f"[e2e] volume {volume['num_voxels']} voxels at {volume['voxel_size']:.5f} m, "
        f"{volume['dtype']}; {profiling['elapsed_time']['per_frame']:.4f} s/frame "
        f"(run {wall:.1f} s); {profiling['mesh_tri_count']['total']} triangles; "
        f"peak device memory {profiling['peak_vram_usage']['allocated']} B; "
        f"launches {launches['main']}; each call also ran its plain version (the band "
        f"update's on a snapshot of the frame's band rows, which raises the peak)")
    log("[e2e] profiling.json timing (s): " + json.dumps(rounded(profiling["timing"])))
    return check.results(), profiling


# ---------------------------------------------------------------------------
# The multi-device layer, split k ways on one card.
# ---------------------------------------------------------------------------

# The bench integration's splits (a 4-way one is left out for the script's
# time, under its 1200 s).
SHARD_SPLITS = (2,)
SHARD_TRACED_FRAMES = 8
# The split pose optimisation (float64, pose-optimise's 178k correspondences,
# POSE_SHARD_EPOCHS epochs, no plateau or early stop) against the unsplit
# run, max |difference| of q and t: the shards' partial loss sums meet in
# another order, and Adam grows that last-bit difference over the epochs:
# measured 8.56e-8 on an H100 80GB HBM3 (700 W), where two unsplit runs
# were bit-equal (the CPU test holds 2 and 8 CPU shards within 1e-9 on a
# 64-correspondence problem, tests/test_torch_parallel.py). A split that
# loses a shard moves t by about as much as the run does (0.135 m).
POSE_SHARD_TOL = 1e-6
POSE_SHARD_EPOCHS = 100
# The CLI runs of [shard]: frames, width, height, and a voxel budget that
# keeps each run to a few seconds.
SHARD_CLI = (4, 128, 96)
SHARD_CLI_VOXELS = 2_000_000


def one_card_mesh(device, k: int):
    """A k-shard mesh that names ``device`` k times."""
    from hive_tpu_torch.parallel.mesh import get_device_mesh

    return get_device_mesh(devices=[device] * k)


def integration_run(label: str, volume, mesh, frames, device) -> dict:
    """One integration of the bench ``frames`` into ``volume`` (its rows
    split over ``mesh``, unless None), the launch counts reset before and
    read after: its wall s, launches, peak device memory and the state
    after it; then an integration of the first SHARD_TRACED_FRAMES frames,
    profiled (device ms and kernels a frame: the trace's processing on the
    host grows with its kernels, and a 4-way split of all 64 frames has
    57k)."""
    from hive_tpu_torch.parallel.fusion import integrate_frames_sharded

    def integrate(count=None):
        depths, colors, K, poses = frames
        depths, colors, poses = depths[:count], colors[:count], poses[:count]
        if mesh is None:
            volume.integrate_frames(colors, depths, K, poses)
        else:
            integrate_frames_sharded(volume, mesh, colors, depths, K, poses)

    reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    start = time.perf_counter()
    integrate()
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    counts = main_launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    state = [x.clone() for x in volume.state]
    start = time.perf_counter()
    ms, ops = device_profile(lambda: integrate(SHARD_TRACED_FRAMES), reps=1, warmup=0)
    return dict(label=label, wall_s=wall, launches=counts, peak_bytes=int(peak),
                device_ms_per_frame=ms / SHARD_TRACED_FRAMES,
                kernels_per_frame=ops / SHARD_TRACED_FRAMES, state=state,
                profile_s=time.perf_counter() - start)


def check_shard_frame(device, frames, k: int) -> float:
    """Bench frame 0 on each slab of a fresh k-way cyclic split: both
    classification passes and the band update bit-exact against their
    plain versions on the slab's rows, origins and caps."""
    from hive_tpu_torch.ops import classify_blocks as cb
    from hive_tpu_torch.ops.tsdf_sparse import (SparseTSDFVolume, build_flat_pyramid,
                                                pick_compact_cap)
    from hive_tpu_torch.parallel.fusion import shard_sparse_state

    depths, _, K, poses = frames
    volume = SparseTSDFVolume([[-2.0, 2.0], [-2.0, 2.0], [0.0, 4.0]],
                              voxel_size=4.0 / BENCH_GRID, device=device)
    shard_sparse_state(volume, one_card_mesh(device, k))
    level = pick_compact_cap(volume.estimate_candidate_fraction(K, poses, BENCH_H, BENCH_W))
    w2c = torch.linalg.inv(torch.as_tensor(poses[0], device=device))
    intr = torch.tensor([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], device=device)
    scal = cb.classify_scalars(w2c[:3, :3], w2c[:3, 3], intr)
    pyramid = build_flat_pyramid(depths[0], BENCH_H, BENCH_W, packed_u16=True)
    err = 0.0
    for slab in volume.shards:
        integ = volume._integrator(BENCH_H, BENCH_W, level, slab.origins.shape[0], slab.device)
        err = max(err, classify_exact(slab.origins, scal, pyramid, integ.geometry,
                                      integ.pass1_cap, integ.refine_cap, integ.SUB > 1)[2])
        call = band_call(volume, frames, 0, device, slab=slab)
        if call["ids"].numel() == 0:
            raise AssertionError(f"a slab of the {k}-way split has no band on bench frame 0")
        err = max(err, band_update_exact(call))
    return err


def check_shards(device, launches, e2e: str, tmp: str, smi: str) -> dict:
    """[shard]: the multi-device layer (``--num_devices``) split k ways on
    one card (a mesh naming the card k times): every number is a k-shard
    run on one card, not a multi-card one."""
    from hive_tpu_torch import fusion
    from hive_tpu_torch.io import HiveDataset
    from hive_tpu_torch.ops.tsdf_sparse import SparseTSDFVolume
    from hive_tpu_torch.options import BackgroundMeshOptions
    from hive_tpu_torch.parallel import runtime
    from hive_tpu_torch.parallel.fusion import integrate_frames_sharded, shard_sparse_state

    phase_start = time.perf_counter()
    label = f"on one card ({smi})"
    out = {"card": smi, "device_count": torch.cuda.device_count()}

    # Bench-shape integration, split SHARD_SPLITS ways in both placements.
    frames = bench_frames(device)
    depths, colors, K, poses = frames
    bounds = np.array([[-2.0, 2.0], [-2.0, 2.0], [0.0, 4.0]], np.float32)

    def volume():
        return SparseTSDFVolume(bounds, voxel_size=4.0 / BENCH_GRID, device=device)

    runs = [integration_run("unsplit", volume(), None, frames, device)]
    want = runs[0].pop("state")
    check_launches("[shard] unsplit bench integration", runs[0]["launches"], BENCH_FRAMES)
    shard_launches = dict.fromkeys(MainPathCheck.NAMES, 0)
    for k in SHARD_SPLITS:
        for placement in ("contiguous", "cyclic"):
            mesh = one_card_mesh(device, k)
            split = volume()
            shard_sparse_state(split, mesh, placement=placement)
            run = integration_run(f"{k} shards, {placement}", split, mesh, frames,
                                  device)
            state = run.pop("state")
            del split
            for name, got, exp in zip(("tsdf", "weight", "color"), state, want):
                if not torch.equal(got, exp):
                    raise AssertionError(f"[shard] {k}-way {placement} split differs from the "
                                         f"unsplit kernel path in {name}")
            counts = run["launches"]
            check_launches(f"[shard] {k}-way {placement} bench integration", counts,
                           BENCH_FRAMES, shards=k)
            # Cyclic placement spreads the band: every slab has some each frame.
            if placement == "cyclic" and counts["band_update"] != k * BENCH_FRAMES:
                raise AssertionError(f"[shard] {k}-way cyclic: {counts['band_update']} band "
                                     f"updates in {BENCH_FRAMES} frames")
            for name in shard_launches:
                shard_launches[name] += counts[name]
            if placement == "cyclic":
                plain = volume()
                shard_sparse_state(plain, mesh)
                patches = plain_paths()
                with patches[0], patches[1], patches[2]:
                    integrate_frames_sharded(plain, mesh, colors, depths, K, poses)
                for name, got, exp in zip(("tsdf", "weight", "color"), plain.state, state):
                    if not torch.equal(got, exp):
                        raise AssertionError(f"[shard] {k}-way split: kernel and plain paths "
                                             f"differ in {name}")
                del plain
            del state
            runs.append(run)
    del want
    torch.cuda.empty_cache()
    frame_err = max(check_shard_frame(device, frames, k) for k in SHARD_SPLITS)
    del frames
    torch.cuda.empty_cache()
    for run in runs:
        log(f"[shard] bench integration (VGA x {BENCH_FRAMES} into {BENCH_GRID}^3), "
            f"{run['label']} {label}: {run['wall_s'] * 1e3:.1f} ms wall, launches "
            f"{run['launches']}, peak device memory {run['peak_bytes']} B; "
            f"{run['device_ms_per_frame']:.4f} ms device and {run['kernels_per_frame']:.1f} "
            f"kernels a frame (a traced rep of {SHARD_TRACED_FRAMES} frames)")
    log(f"[shard] every split state bit-identical to the unsplit kernel path; the cyclic "
        f"splits' also to their plain paths; 2k classification launches and (cyclic) k band "
        f"updates a frame; bench frame 0 on each slab of the {SHARD_SPLITS} cyclic splits "
        f"bit-exact against the plain versions (max |difference| {frame_err})")
    out["bench"] = runs
    out["frame_max_abs_err"] = frame_err
    launches["shard"] = shard_launches

    parts = {"bench": time.perf_counter() - phase_start,
             "of which profiling": sum(run.pop("profile_s") for run in runs)}
    e2e_start = time.perf_counter()

    # The e2e dataset at the default 320M budget through fusion.tsdf_fusion.
    dataset = HiveDataset(e2e)
    meshes = {}
    for name, mesh in (("unsplit", None), ("2 shards", one_card_mesh(device, 2))):
        runtime.set_runtime_mesh(mesh)
        try:
            reset_launch_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            start = time.perf_counter()
            profiling = {}
            meshes[name] = fusion.tsdf_fusion(dataset, BackgroundMeshOptions(),
                                              num_frames=E2E_FRAMES, profiling=profiling,
                                              device=device)
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
        finally:
            runtime.set_runtime_mesh(None)
        counts = main_launch_counts()
        check_launches(f"[shard] e2e tsdf_fusion, {name}", counts, E2E_FRAMES,
                       shards=1 if mesh is None else mesh.size)
        stages = profiling["timing"]["background_reconstruction"]
        out[f"e2e_{name}"] = dict(wall_s=wall, launches=counts,
                                  peak_bytes=int(torch.cuda.max_memory_allocated(device)),
                                  stages=stages)
        log(f"[shard] e2e tsdf_fusion at the 320M budget, {name} {label}: {wall:.3f} s "
            f"(integration {stages['integration']:.3f} s, mesh_extraction "
            f"{stages['mesh_extraction']:.3f} s), launches {counts}, peak device memory "
            f"{out[f'e2e_{name}']['peak_bytes']} B")
    for attribute in ("vertices", "faces", "vertex_colors", "vertex_normals"):
        if not np.array_equal(getattr(meshes["unsplit"], attribute),
                              getattr(meshes["2 shards"], attribute)):
            raise AssertionError(f"[shard] e2e mesh split 2 ways differs in {attribute}")
    log(f"[shard] e2e mesh split 2 ways equals the unsplit one: "
        f"{len(meshes['unsplit'].vertices)} vertices, {len(meshes['unsplit'].faces)} faces")
    del meshes, dataset
    torch.cuda.empty_cache()

    parts["e2e"] = time.perf_counter() - e2e_start
    for name, check in (("cli", lambda: check_shard_cli(device, tmp)),
                        ("dpt", lambda: check_shard_dpt(device, tmp, label)),
                        ("pose", lambda: check_shard_pose(device, label))):
        start = time.perf_counter()
        out[name] = check()
        parts[name] = time.perf_counter() - start
    log(f"[shard] the phase took {time.perf_counter() - phase_start:.1f} s ("
        + ", ".join(f"{name} {s:.1f} s" for name, s in parts.items()) + ")")
    return out


def glb_mesh(path: str):
    from hive_tpu_torch.meshing.gltf import load_glb

    return next(iter(load_glb(os.path.join(path, "mesh", "bg.glb")).geometry.values()))


def check_shard_cli(device, tmp: str) -> dict:
    """The CLI with ``--num_devices`` on a small dataset (SHARD_CLI),
    ``--background_only``: 1 as the baseline; 2 refused before anything is
    written on one card (naming the counts), else equal to 1's ``bg.glb``;
    -1 equal to 1's (the single-device path on one card: no split)."""
    from hive_tpu_torch import fusion
    from hive_tpu_torch.parallel import runtime

    count = torch.cuda.device_count()
    source = os.path.join(tmp, "shard_cli")
    write_hive_dataset(source, *SHARD_CLI)

    def cli(num_devices: str):
        path = f"{source}_{num_devices}"
        shutil.copytree(source, path)
        argv = ["hive_tpu_torch", "--dataset_path", path, "--output_path", path,
                "--background_only", "--num_frames", str(SHARD_CLI[0]),
                "--key_frame_threshold", "1.0", "--overwrite_ok",
                "--sdf_max_voxels", str(SHARD_CLI_VOXELS),
                "--webxr_path", os.path.join(path, "webxr"),
                "--log_file", os.path.join(path, "pipeline.log"), "--num_devices", num_devices]
        with mock.patch.object(sys, "argv", argv), \
                mock.patch.object(fusion, "shard_sparse_state",
                                  wraps=fusion.shard_sparse_state) as shard:
            runpy.run_module("hive_tpu_torch", run_name="__main__", alter_sys=True)
        if runtime.runtime_mesh() is not None:
            raise AssertionError("the runtime mesh outlived the run")
        return path, shard.call_count

    base, _ = cli("1")
    want = glb_mesh(base)
    result = {"device_count": count}
    if count < 2:
        try:
            cli("2")
        except ValueError as exc:
            if "Requested 2 CUDA devices but only 1" not in str(exc):
                raise
            if os.path.exists(os.path.join(f"{source}_2", "mesh")):
                raise AssertionError("--num_devices 2 wrote a mesh folder before refusing")
            result["num_devices_2"] = f"refused: {exc}"
        else:
            raise AssertionError("--num_devices 2 ran on one card")
    else:
        path, splits = cli("2")
        got = glb_mesh(path)
        if splits != 1 or not all(np.array_equal(getattr(got, a), getattr(want, a))
                                  for a in ("vertices", "faces", "vertex_colors")):
            raise AssertionError("--num_devices 2: bg.glb differs from --num_devices 1's")
        result["num_devices_2"] = "bg.glb equal to --num_devices 1's"
    path, splits = cli("-1")
    got = glb_mesh(path)
    if (splits != 0) != (count >= 2) or not all(
            np.array_equal(getattr(got, a), getattr(want, a))
            for a in ("vertices", "faces", "vertex_colors")):
        raise AssertionError(f"--num_devices -1 on {count} cards: split {splits} times, or "
                             f"bg.glb differs from --num_devices 1's")
    result["num_devices_-1"] = (f"{'split' if splits else 'single-device'}, bg.glb equal to "
                                f"--num_devices 1's ({len(want.vertices)} vertices)")
    log(f"[shard] CLI on {count} card(s), {SHARD_CLI[0]} frames of {SHARD_CLI[1]}x"
        f"{SHARD_CLI[2]}: --num_devices 2 {result['num_devices_2']}; --num_devices -1 "
        f"{result['num_devices_-1']}")
    return result


def check_shard_dpt(device, tmp: str, label: str) -> dict:
    """DPT bf16 at the CLI's 8x480x640 batch through ``predict_batch``,
    split 2 ways on the card, against the unsplit estimator: depth within
    DPT_CPU_BF16_TOL of the unsplit's, max |difference| over max depth."""
    from hive_tpu_torch.models import dpt

    weights = os.path.join(tmp, "shard_weights")
    os.makedirs(weights, exist_ok=True)
    write_dpt_weights(weights)
    frames = np.random.default_rng(SEED).integers(0, 256, (8, 480, 640, 3), dtype=np.uint8)
    result = {}
    depths = {}
    with mock.patch.dict(os.environ, {"WEIGHTS_PATH": weights}):
        estimator = dpt.DPTDepthEstimator(device=device, mesh=None)
    for name, mesh in (("unsplit", None), ("2 shards", one_card_mesh(device, 2))):
        # One estimator (one load of the weights): on one card both shards
        # run its own model.
        estimator.mesh = mesh
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        depths[name] = estimator.predict_batch(frames)
        peak = int(torch.cuda.max_memory_allocated(device))
        ms, ops = device_profile(lambda: estimator.predict_batch(frames), reps=2, warmup=1)
        result[name] = dict(device_ms=ms, device_ops=ops, peak_bytes=peak)
        log(f"[shard] DPT bf16 predict_batch 8x480x640, {name} {label}: {ms:.4f} ms "
            f"device ({ops:.0f} kernels), peak device memory {peak} B")
    del estimator
    torch.cuda.empty_cache()
    err = float(np.abs(depths["2 shards"] - depths["unsplit"]).max()
                / np.abs(depths["unsplit"]).max())
    result["rel_err"] = err
    log(f"[shard] DPT split 2 ways vs unsplit: {err:.4g} relative (max depth "
        f"{float(depths['unsplit'].max()):.4f} m), want < {DPT_CPU_BF16_TOL}")
    if not (np.isfinite(depths["2 shards"]).all() and err < DPT_CPU_BF16_TOL):
        raise AssertionError(f"[shard] DPT split 2 ways: {err:.3g} relative to the unsplit "
                             f"depth, want < {DPT_CPU_BF16_TOL}")
    return result


def check_shard_pose(device, label: str) -> dict:
    """pose-optimise's problem through optimise_packed_features in float64
    (World3D with smoothing, POSE_SHARD_EPOCHS epochs, no plateau or early
    stop), split 2 ways on the card, against the unsplit run: q and t
    within POSE_SHARD_TOL; the spread of two unsplit runs is logged."""
    from hive_tpu_torch import pose_optimisation as P

    _, _, features, _, perturbed = pose_user_problem()
    feats, intrinsics = packed_on(features, device, torch.float64)
    start = {"q": perturbed[:, :4], "t": perturbed[:, 4:], "scale": np.zeros(0),
             "shift": np.zeros(0)}
    options = P.OptimisationOptions(num_epochs=POSE_SHARD_EPOCHS, lr_scheduler_patience=10 ** 6,
                                    early_stopping_patience=10 ** 6)
    result, params = {}, {}
    for name, mesh in (("unsplit", None), ("unsplit again", None),
                       ("2 shards", one_card_mesh(device, 2))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        begin = time.perf_counter()
        out = P.optimise_packed_features(feats, intrinsics, start, options,
                                         residual_type=P.ResidualType.World3D,
                                         frame_size=(POSE_W, POSE_H), fps=30.0, mesh=mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - begin
        params[name] = {k: out[k].cpu().numpy() for k in ("q", "t")}
        result[name] = dict(wall_s=wall, peak_bytes=int(torch.cuda.max_memory_allocated(device)))
        log(f"[shard] pose-optimise float64, {len(features)} correspondences, "
            f"{POSE_SHARD_EPOCHS} epochs, {name} {label}: {wall:.3f} s wall, peak device "
            f"memory {result[name]['peak_bytes']} B")
    def difference(a, b):
        return max(float(np.abs(params[a][k] - params[b][k]).max()) for k in ("q", "t"))

    err, repeat = difference("2 shards", "unsplit"), difference("unsplit again", "unsplit")
    moved = float(np.abs(params["unsplit"]["t"] - perturbed[:, 4:]).max())
    result.update(max_abs_err=err, repeat_max_abs_err=repeat, moved=moved)
    log(f"[shard] pose split 2 ways vs unsplit: max |difference| {err:.3e} (tol "
        f"{POSE_SHARD_TOL}; two unsplit runs {repeat:.3e} apart); the unsplit run moved t "
        f"by {moved:.4f} m")
    if not err <= POSE_SHARD_TOL or not moved > 1e-3:
        raise AssertionError(f"[shard] pose split 2 ways: {err:.3e} from the unsplit run (tol "
                             f"{POSE_SHARD_TOL}), t moved {moved:.3e}")
    return result


# ---------------------------------------------------------------------------
# Conversion of a TUM sequence, and a user's run.
# ---------------------------------------------------------------------------

TUM_FRAMES, TUM_H, TUM_W = 30, 480, 640
# create_masks' first batch of 8 primes the motion segmenter: the blob's
# silhouette is held to the masks of the frames after it.
TUM_PRIMED = 8
# Least IoU of each such frame's mask with the blob's silhouette; a CPU
# rehearsal of this scene at this size read 0.752 to 0.925.
TUM_IOU = 0.7


def write_tum_dataset(base: str, num_frames: int, width: int, height: int,
                      seed: int = SEED) -> np.ndarray:
    """A TUM RGB-D folder seen through TUMAdaptor's fixed intrinsics (fx =
    fy = 580 px, cx 319.5, cy 239.5) from a static camera: a textured wall
    at 2 m, and a (200, 64, 64) blob at 1.5 m that jumps about the frame, a
    diameter or more a frame, so background subtraction does not absorb it;
    noise of a few levels from ``seed``. RGB at 30 Hz, depth 4 ms after it at
    5000 units a metre, ground truth at 100 Hz; PNGs with adaptive row
    filters, as TUM ships them. Returns the blob's silhouette per frame."""
    from hive_tpu_torch.image_codecs import encode_png

    rng = np.random.default_rng(seed)
    for sub in ("rgb", "depth"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    ys, xs = np.mgrid[0:height, 0:width]
    wall = np.stack([60 + 40 * np.sin(xs / 7.0), xs * 255.0 / width, ys * 255.0 / height], -1)
    lists = {"rgb.txt": ["# color images"], "depth.txt": ["# depth maps"],
             "groundtruth.txt": ["# timestamp tx ty tz qx qy qz qw"]}
    t0 = 1305031102.0
    for k in range(int((num_frames / 30.0 + 0.1) * 100)):
        lists["groundtruth.txt"].append(f"{t0 - 0.05 + k / 100:.4f} 0 0 0 0 0 0 1")
    radius = height / 12
    silhouettes = []
    for i in range(num_frames):
        cx = width / 2 + (width / 2 - 2 * radius) * np.sin(0.9 * i)
        cy = height / 2 + (height / 2 - 2 * radius) * np.sin(0.55 * i + 1.0)
        blob = (xs - cx) ** 2 + (ys - cy) ** 2 < radius ** 2
        rgb = wall.copy()
        rgb[blob] = (200, 64, 64)
        rgb = np.clip(rgb + rng.normal(0, 2, rgb.shape), 0, 255).astype(np.uint8)
        depth = np.where(blob, 7500, 10000).astype(np.uint16)
        t = t0 + i / 30.0
        for sub, stamp, image in (("rgb", t, rgb), ("depth", t + 0.004, depth)):
            name = f"{stamp:.6f}.png"
            with open(os.path.join(base, sub, name), "wb") as f:
                f.write(encode_png(image))
            lists[f"{sub}.txt"].append(f"{stamp:.6f} {sub}/{name}")
        silhouettes.append(blob)
    for name, lines in lists.items():
        with open(os.path.join(base, name), "w") as f:
            f.write("\n".join(lines) + "\n")
    return np.stack(silhouettes)


# The textured wall of the feature phases: blurred noise at several scales
# (corners for SIFT at every octave), TEXTURE_PPM texels a metre, on the
# plane z = WALL_Z_M of the world.
WALL_Z_M, TEXTURE_PPM = 2.0, 400


def wall_texture(seed: int = SEED, extent=(-2.5, 2.5, -2.0, 2.0)) -> np.ndarray:
    """A grey float texture in [0, 255] over ``extent`` (x0, x1, y0, y1 in
    metres): the sum of bicubically upsampled noise with cells of 4 to 64
    texels, equally weighted (about 4,800 SIFT keypoints in a VGA view)."""
    rng = np.random.default_rng(seed)
    height = int((extent[3] - extent[2]) * TEXTURE_PPM)
    width = int((extent[1] - extent[0]) * TEXTURE_PPM)
    texture = torch.zeros((height, width), dtype=torch.float64)
    for cell in (4, 8, 16, 32, 64):
        noise = torch.from_numpy(rng.standard_normal((height // cell + 3, width // cell + 3)))
        up = torch.nn.functional.interpolate(noise[None, None], scale_factor=cell,
                                             mode="bicubic", align_corners=False)[0, 0]
        texture += up[cell:cell + height, cell:cell + width]
    texture = (texture - texture.min()) / (texture.max() - texture.min()) * 255
    return texture.numpy()


def wall_camera() -> np.ndarray:
    """The intrinsics that ``--estimate_pose`` assumes without COLMAP on a
    TUM folder: the Kinect prior scaled to the adaptor's 640x480 metadata,
    whatever the frames' size."""
    from hive_tpu_torch.sensor import KinectSensor

    return KinectSensor.get_camera_matrix().scale((480, 640)).matrix


def wall_trajectory(num_frames: int, step_m: float = 0.01, yaw_deg: float = 0.15) -> np.ndarray:
    """World-to-camera 7-vectors (qx qy qz qw tx ty tz) of a camera looking
    at the wall while it slides ``step_m`` along x and ``step_m / 3`` along
    y a frame and turns ``yaw_deg`` about y a frame."""
    poses = []
    for i in range(num_frames):
        half = np.radians(yaw_deg * i) / 2
        q_cw = np.array([0.0, np.sin(half), 0.0, np.cos(half)])       # camera to world
        c, s = np.cos(2 * half), np.sin(2 * half)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]).T              # world to camera
        centre = np.array([step_m * i, step_m * i / 3, 0.0])
        q = q_cw * np.array([-1, -1, -1, 1])
        poses.append(np.concatenate([q, -R @ centre]))
    return np.asarray(poses)


def render_wall(texture: np.ndarray, pose: np.ndarray, K: np.ndarray, width: int, height: int,
                extent=(-2.5, 2.5, -2.0, 2.0)):
    """The wall seen from a world-to-camera 7-vector: (H, W, 3) uint8 RGB
    (the texture bilinearly sampled, tinted per channel) and (H, W) float64
    depth in metres."""
    from hive_tpu_torch.geometric import pose_vec2mat

    M = pose_vec2mat(pose)
    R, t = M[:3, :3], M[:3, 3]
    vs, us = np.mgrid[0:height, 0:width].astype(np.float64)
    rays = np.stack([(us - K[0, 2]) / K[0, 0], (vs - K[1, 2]) / K[1, 1], np.ones_like(us)], -1)
    origin = -R.T @ t
    world = rays @ R                                   # R^T applied to each ray
    depth = (WALL_Z_M - origin[2]) / world[..., 2]
    x = (origin[0] + depth * world[..., 0] - extent[0]) * TEXTURE_PPM
    y = (origin[1] + depth * world[..., 1] - extent[2]) * TEXTURE_PPM
    x0 = np.clip(np.floor(x).astype(np.int64), 0, texture.shape[1] - 2)
    y0 = np.clip(np.floor(y).astype(np.int64), 0, texture.shape[0] - 2)
    fx, fy = np.clip(x - x0, 0, 1), np.clip(y - y0, 0, 1)
    grey = ((texture[y0, x0] * (1 - fx) + texture[y0, x0 + 1] * fx) * (1 - fy)
            + (texture[y0 + 1, x0] * (1 - fx) + texture[y0 + 1, x0 + 1] * fx) * fy)
    rgb = np.stack([grey * 0.9 + 20, grey, grey * 0.8 + 30], -1)
    return np.clip(np.rint(rgb), 0, 255).astype(np.uint8), depth


def write_wall_tum(base: str, num_frames: int, width: int, height: int,
                   poses: np.ndarray, seed: int = SEED) -> None:
    """A TUM RGB-D folder of the textured wall seen from the world-to-camera
    ``poses``: RGB at 30 Hz, depth 4 ms after it at 5000 units a metre,
    ground truth at 100 Hz (camera to world, as TUM stores it; each row the
    pose of the frame whose depth stamp is nearest)."""
    from hive_tpu_torch.geometric import Trajectory
    from hive_tpu_torch.image_codecs import encode_png

    texture = wall_texture(seed)
    K = wall_camera()
    cam_to_world = Trajectory(np.asarray(poses, dtype=np.float64)).inverse().values
    for sub in ("rgb", "depth"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    lists = {"rgb.txt": ["# color images"], "depth.txt": ["# depth maps"],
             "groundtruth.txt": ["# timestamp tx ty tz qx qy qz qw"]}
    t0 = 1305031102.0
    depth_stamps = t0 + np.arange(num_frames) / 30.0 + 0.004
    for i in range(num_frames):
        rgb, depth = render_wall(texture, poses[i], K, width, height)
        t = t0 + i / 30.0
        for sub, stamp, image in (("rgb", t, rgb),
                                  ("depth", t + 0.004, np.rint(depth * 5000).astype(np.uint16))):
            name = f"{stamp:.6f}.png"
            with open(os.path.join(base, sub, name), "wb") as f:
                f.write(encode_png(image))
            lists[f"{sub}.txt"].append(f"{stamp:.6f} {sub}/{name}")
    for k in range(int((num_frames / 30.0 + 0.1) * 100)):
        stamp = t0 - 0.05 + k / 100
        qx, qy, qz, qw, tx, ty, tz = cam_to_world[int(np.abs(depth_stamps - stamp).argmin())]
        lists["groundtruth.txt"].append(
            " ".join([f"{stamp:.4f}"] + [repr(float(v)) for v in (tx, ty, tz, qx, qy, qz, qw)]))
    for name, lines in lists.items():
        with open(os.path.join(base, name), "w") as f:
            f.write("\n".join(lines) + "\n")


def camera_centres(values: np.ndarray) -> np.ndarray:
    """Camera centres of world-to-camera 7-vectors, in the frame of the
    first camera (each pose rebased as ``M_i @ inv(M_0)``)."""
    from hive_tpu_torch.geometric import pose_vec2mat

    mats = [pose_vec2mat(v) for v in np.asarray(values, dtype=np.float64)]
    first = np.linalg.inv(mats[0])
    return np.stack([-(m @ first)[:3, :3].T @ (m @ first)[:3, 3] for m in mats])


def ate_m(truth: np.ndarray, estimate: np.ndarray) -> float:
    """Absolute trajectory error (RMSE of the camera centres, metres) of two
    metric world-to-camera trajectories, both seen from their first camera
    (no alignment: the odometry's scale is metric and its first pose the
    identity)."""
    a, b = camera_centres(truth), camera_centres(estimate)
    return float(np.sqrt(((a - b) ** 2).sum(axis=1).mean()))


# The stand-in ``colmap`` of the --estimate_pose runs: it writes a sparse
# model of the staged frames from given world-to-camera poses and wall
# points, in COLMAP's units (metres x COLMAP_SCALE), as a real COLMAP run
# lands at an arbitrary scale.
COLMAP_SCALE = 0.37
COLMAP_STAND_IN = """#!{python}
import argparse, json, os, sys

import numpy as np

sys.path.insert(0, {repo!r})
from hive_tpu_torch.data import colmap_model as cm
from hive_tpu_torch.geometric import pose_vec2mat

parser = argparse.ArgumentParser()
parser.add_argument("command")
parser.add_argument("--workspace_path")
parser.add_argument("--image_path")
args, _ = parser.parse_known_args()
with open({spec!r}) as f:
    spec = json.load(f)
K, (width, height), scale = np.array(spec["K"]), spec["size"], spec["scale"]
names = sorted(os.listdir(args.image_path))
# The staged frames are the adaptor's subset, renumbered densely.
subset = list(range(0, len(spec["poses"]), spec["frame_step"]))
subset += [len(spec["poses"]) - 1] if subset[-1] != len(spec["poses"]) - 1 else []
points = np.array(spec["points"])
cameras = {{1: cm.ColmapCamera(1, "PINHOLE", width, height,
                               np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]))}}
images = {{}}
for i, name in enumerate(names):
    pose = spec["poses"][subset[int(name.split(".")[0])]]
    M = pose_vec2mat(np.array(pose))
    cam = points @ M[:3, :3].T + M[:3, 3]
    uv = cam[:, :2] / cam[:, 2:] * K[[0, 1], [0, 1]] + K[:2, 2]
    seen = ((cam[:, 2] > 0) & (uv[:, 0] > 0) & (uv[:, 0] < width) & (uv[:, 1] > 0)
            & (uv[:, 1] < height))
    q = pose[:4]
    images[i + 1] = cm.ColmapImage(i + 1, np.array([q[3], q[0], q[1], q[2]]),
                                   scale * M[:3, 3], 1, name, uv[seen],
                                   np.flatnonzero(seen).astype(np.int64))
points3d = {{j: cm.ColmapPoint3D(j, scale * p, np.array([128, 128, 128]), 0.5)
            for j, p in enumerate(points)}}
model = os.path.join(args.workspace_path, "sparse", "0")
os.makedirs(model, exist_ok=True)
cm.write_model(model, cameras, images, points3d)
print(f"stand-in colmap: {{len(images)}} images, {{len(points3d)}} points")
"""


def write_colmap_stand_in(folder: str, poses: np.ndarray, K: np.ndarray, size,
                          depth: float, frame_step: int, grid: int = 24) -> str:
    """Write the stand-in ``colmap`` (an executable Python script) and its
    spec into ``folder``; returns the script's path. ``poses`` are the
    frames' world-to-camera 7-vectors in metres, of which the adaptor stages
    every ``frame_step``-th and the last; the points are a ``grid`` x
    ``grid`` lattice over frame 0's view at ``depth`` metres (the wall), in
    world coordinates."""
    from hive_tpu_torch.geometric import pose_vec2mat

    os.makedirs(folder, exist_ok=True)
    width, height = size
    us, vs = np.meshgrid(np.linspace(2, width - 3, grid), np.linspace(2, height - 3, grid))
    cam = np.stack([(us.ravel() - K[0, 2]) / K[0, 0] * depth,
                    (vs.ravel() - K[1, 2]) / K[1, 1] * depth,
                    np.full(us.size, depth)], axis=-1)
    M = pose_vec2mat(np.asarray(poses[0], dtype=np.float64))
    points = (cam - M[:3, 3]) @ M[:3, :3]
    spec = os.path.join(folder, "colmap.json")
    with open(spec, "w") as f:
        json.dump({"K": np.asarray(K).tolist(), "size": [int(width), int(height)],
                   "scale": COLMAP_SCALE, "frame_step": frame_step,
                   "poses": np.asarray(poses).tolist(),
                   "points": points.tolist()}, f)
    script = os.path.join(folder, "colmap")
    with open(script, "w") as f:
        f.write(COLMAP_STAND_IN.format(python=sys.executable, repo=REPO, spec=spec))
    os.chmod(script, 0o755)
    return script


def copy_tum_with_poses(tum: str, dest: str, poses: np.ndarray) -> None:
    """Copy a TUM folder to ``dest`` with its ground truth rewritten so
    that TUMAdaptor, which takes each frame's pose from the 100 Hz row
    nearest its depth stamp, reads ``poses[i]`` (qx qy qz qw tx ty tz,
    camera to world, as TUM stores it) for frame i: each row holds the pose
    of the frame whose depth stamp is nearest to it."""
    shutil.copytree(tum, dest)

    def rows(name):
        with open(os.path.join(dest, name)) as f:
            return [line.split() for line in f if line.strip() and not line.startswith("#")]

    depth_stamps = np.array([float(row[0]) for row in rows("depth.txt")])
    lines = ["# timestamp tx ty tz qx qy qz qw"]
    for row in rows("groundtruth.txt"):
        qx, qy, qz, qw, tx, ty, tz = poses[np.abs(depth_stamps - float(row[0])).argmin()]
        lines.append(" ".join([row[0]] + [repr(float(v)) for v in (tx, ty, tz, qx, qy, qz, qw)]))
    with open(os.path.join(dest, "groundtruth.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


def time_mog2(device, tum: str) -> dict:
    """Device ms of one MOG2 step and of the open and close at TUM's width,
    on the folder's frame after the priming batch; MOG2 also as a launch
    loop (CUDA events, host cost included)."""
    from hive_tpu_torch.io import load_image
    from hive_tpu_torch.models.segmentation import _MotionBackend, open_close

    names = sorted(os.listdir(os.path.join(tum, "rgb")))[:TUM_PRIMED + 1]
    frames = torch.from_numpy(np.stack([load_image(os.path.join(tum, "rgb", name))
                                        for name in names])).to(device)
    backend = _MotionBackend(device=device)
    backend.prime(frames[:TUM_PRIMED])
    bgr = frames[TUM_PRIMED].flip(-1).contiguous()
    mog2_ms, mog2_ops = device_profile(lambda: backend.apply(bgr), reps=20, warmup=3)
    loop_ms = events_ms(lambda: backend.apply(bgr), reps=20, warmup=0)
    fg = (backend.apply(bgr) >= 200)[None]
    morph_ms, morph_ops = device_profile(lambda: open_close(fg), reps=20, warmup=3)
    times = dict(mog2_ms=mog2_ms, mog2_device_ops=mog2_ops, mog2_loop_ms=loop_ms,
                 open_close_ms=morph_ms, open_close_device_ops=morph_ops)
    log(f"[convert] MOG2 step at {TUM_W}x{TUM_H}: {mog2_ms:.6f} ms device ({mog2_ops:.0f} "
        f"kernels), {loop_ms:.6f} ms launch loop (events); open + close "
        f"{morph_ms:.6f} ms device ({morph_ops:.0f} kernels)")
    return times


def flat_totals(tree, prefix=""):
    """Stage -> seconds of a profiling.json ``timing`` tree (roll-ups by
    their totals)."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            if set(value) == {"count", "total", "mean"}:
                out[prefix + key] = value["total"]
            else:
                out.update(flat_totals(value, f"{prefix}{key}."))
        elif not isinstance(value, bool):
            out[prefix + key] = value
    return out


def run_conversion(device, launches, main_profiling, tmp: str):
    """A user's run on a TUM folder: ``python -m hive_tpu_torch`` converts it
    (JPEG frames, motion masks on the card) and meshes it, in this process,
    with no check patched in. Checks the converted folder, the launch
    counts, the card's masks against the CPU's on the same frames, the blob
    found in each frame after priming, and both meshes. The TUM folder is
    written to ``<tmp>/tum``; returns the run's summary and its
    ``profiling.json``."""
    from hive_tpu_torch.io import HiveDataset, ImageFolderDataset, create_masks
    from hive_tpu_torch.meshing.gltf import load_glb

    tum, out = os.path.join(tmp, "tum"), os.path.join(tmp, "converted")
    start = time.perf_counter()
    silhouettes = write_tum_dataset(tum, TUM_FRAMES, TUM_W, TUM_H)
    log(f"[convert] wrote a {TUM_FRAMES}-frame {TUM_W}x{TUM_H} TUM folder in "
        f"{time.perf_counter() - start:.1f} s")
    mog2 = time_mog2(device, tum)

    # Every frame is a key frame: with the default overlap threshold a
    # static camera's frames all overlap frame 0, which alone is fused.
    argv = ["hive_tpu_torch", "--dataset_path", tum, "--output_path", out,
            "--key_frame_threshold", "1.0", "--webxr_path", os.path.join(tmp, "webxr"),
            "--log_file", os.path.join(tmp, "pipeline.log")]
    reset_launch_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    with mock.patch.object(sys, "argv", argv):
        runpy.run_module("hive_tpu_torch", run_name="__main__", alter_sys=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches["converted"] = main_launch_counts()
    check_launches("the converted run", launches["converted"], TUM_FRAMES)

    dataset = HiveDataset(out)
    names = dataset.rgb_dataset.image_filenames
    if dataset.num_frames != TUM_FRAMES or names != [f"{i:06d}.jpg"
                                                      for i in range(TUM_FRAMES)]:
        raise AssertionError(f"converted {dataset.num_frames} frames: {names[:3]}...")
    with open(os.path.join(out, "profiling.json")) as f:
        profiling = json.load(f)

    card = np.stack([dataset.mask_dataset[i] for i in range(TUM_FRAMES)])
    start = time.perf_counter()
    create_masks(ImageFolderDataset(dataset.path_to_rgb_frames),
                 os.path.join(tmp, "cpu_masks"), device="cpu")
    cpu_s = time.perf_counter() - start
    cpu = np.stack(list(ImageFolderDataset(os.path.join(tmp, "cpu_masks"))))
    if not np.array_equal(card, cpu):
        raise AssertionError(f"the card's masks differ from the CPU's at "
                             f"{int((card != cpu).sum())} pixels")
    found = card > 0
    ious = (found & silhouettes).sum(axis=(1, 2)) / np.maximum(
        (found | silhouettes).sum(axis=(1, 2)), 1)
    if ious[TUM_PRIMED:].min() < TUM_IOU:
        raise AssertionError(f"blob IoU after priming {np.round(ious[TUM_PRIMED:], 3)}, "
                             f"want >= {TUM_IOU} in each frame")

    foreground = load_glb(os.path.join(out, "mesh", "fg.glb"))
    background = next(iter(load_glb(os.path.join(out, "mesh", "bg.glb")).geometry.values()))
    with_object = [f"{i:06d}" for i in range(TUM_FRAMES) if card[i].any()]
    after = {f"{i:06d}" for i in range(TUM_PRIMED, TUM_FRAMES)}
    if not after <= set(foreground.node_names) <= set(with_object):
        raise AssertionError(f"fg.glb nodes {foreground.node_names}; frames with an "
                             f"object {with_object}")
    for name in foreground.node_names:
        mesh = foreground.geometry[name]
        if mesh.num_faces == 0 or mesh.texture is None or not np.isfinite(
                mesh.vertices).all():
            raise AssertionError(f"fg.glb frame {name}: no finite textured faces")
    if len(background.vertices) == 0 or not np.isfinite(background.vertices).all():
        raise AssertionError("bg.glb holds no (finite) vertices")

    load = profiling["timing"]["load_dataset"]
    log(f"[convert] {TUM_FRAMES} frames converted and meshed in {wall:.1f} s, "
        f"{profiling['elapsed_time']['per_frame']:.4f} s/frame; load_dataset (s): "
        + ", ".join(f"{k} {v:.4f}" for k, v in load.items()))
    log(f"[convert] launches {launches['converted']}; masks from the card equal the CPU's "
        f"(CPU create_masks {cpu_s:.1f} s); blob IoU after priming "
        f"{ious[TUM_PRIMED:].min():.4f}-{ious[TUM_PRIMED:].max():.4f} (mean "
        f"{ious[TUM_PRIMED:].mean():.4f}), in priming {np.round(ious[:TUM_PRIMED], 3).tolist()}; "
        f"fg.glb {len(foreground.node_names)} textured frames; bg.glb "
        f"{len(background.vertices)} vertices; peak device memory "
        f"{profiling['peak_vram_usage']['allocated']} B")
    ours, theirs = flat_totals(main_profiling["timing"]), flat_totals(profiling["timing"])
    log(f"[convert] stage s, e2e run with the check's plain versions ({E2E_FRAMES} synthetic "
        f"frames) | this run without ({TUM_FRAMES} TUM frames): per frame "
        f"{main_profiling['elapsed_time']['per_frame']:.4f} | "
        f"{profiling['elapsed_time']['per_frame']:.4f}; "
        + "; ".join(f"{k} {ours.get(k, float('nan')):.4f} | {theirs.get(k, float('nan')):.4f}"
                    for k in sorted(set(ours) | set(theirs))))
    return dict(mog2, wall_s=wall, per_frame_s=profiling["elapsed_time"]["per_frame"],
                load_dataset=load, iou_min=float(ious[TUM_PRIMED:].min())), profiling

# ---------------------------------------------------------------------------
# Depth from RGB: DPT-Hybrid on the card.
# ---------------------------------------------------------------------------

# (batch, height, width): the graft entry's shape and the CLI's at VGA.
DPT_SHAPES = ((2, 256, 320), (8, 480, 640))
# The card's float32 logits against the CPU's, max |difference| over max
# |logit|: the tolerance of the CPU parity test against hive_tpu
# (tests/test_torch_dpt.py).
DPT_CPU_TOL = 1e-3
# The card's bf16 logits against the CPU's (the same code; each rounds every
# op to bf16, in its own summation order), as DPT_CPU_TOL: measured 0.01395
# on an H100 80GB HBM3 (700 W); a zeroed head gives 1.
DPT_CPU_BF16_TOL = 0.02
# bf16 against float32 logits on the card, |difference| over |fp32| in the
# L2 norm, with the check weights: measured 0.008234 at 2x256x320 and
# 0.009111 at 8x480x640 on an H100 80GB HBM3 (700 W); about 1.6 times the
# larger.
DPT_BF16_TOL = 0.015
# The head's last conv in the weights file of the --estimate_depth run maps
# the check weights' logits x (0.2-2.5 on the TUM scene) to GAIN x + OFFSET,
# where the NYU calibration 1 / (0.000305 x + 0.1378) gives ~1.6-2.2 m,
# about the scene's wall, with ~5 mm steps between neighbouring pixels (a
# CPU forward of one frame). At x1000 alone the depth spanned 0.9-4.3 m
# with ~29 mm steps, and the TSDF meshed a 6.8M-vertex rough surface.
DPT_HEAD_GAIN = 200.0
DPT_HEAD_OFFSET = 1000.0
# The depth maps of that run must span this much: a plane at one depth
# (the reference's random initialisation gives 7.256 m everywhere) fails.
DEPTH_MIN_SPAN_MM = 200
# Published dense peaks of an H100 SXM (NVIDIA data sheet): bf16 on the
# tensor cores; float32 off them (TF32 is off).
DPT_PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}


def top_kernels(fn, count: int = 5) -> str:
    """The ``count`` kernels with the most device time in one call of
    ``fn()``, with their launches (one profiler trace; a breakdown, not a
    timing)."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = sorted(prof.key_averages(), key=self_device_us, reverse=True)[:count]
    return "; ".join(f"{e.key[:70]} x{e.count} {self_device_us(e) / 1e3:.3f} ms" for e in events)


def check_dpt(device) -> dict:
    """DPT-Hybrid at full width on the card, with the check weights from
    the seed, in bf16 and in float32: the card's logits against the CPU's
    in both dtypes on a (2, 64, 96) batch; at each of DPT_SHAPES finite
    logits in both dtypes, bf16 against float32, one forward's device ms
    (profiler) and launch-loop ms (events), frames/s, achieved TFLOP/s
    and its share of the dtype's peak, peak device memory."""
    from hive_tpu_torch.models import dpt
    from hive_tpu_torch.ops.resize import prepare_model_input

    start = time.perf_counter()
    flat = dpt.check_flax_params(seed=SEED)
    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32}
    models = {}
    for name, dtype in dtypes.items():
        with torch.device(device):
            models[name] = dpt.DPTHybrid(dtype=dtype)
        dpt.load_flax_params(models[name], flat).eval()
    rng = np.random.default_rng(SEED)
    small = torch.from_numpy(rng.uniform(-1, 1, (2, 3, 64, 96)).astype(np.float32))
    results = {}
    for name, tol in (("fp32", DPT_CPU_TOL), ("bf16", DPT_CPU_BF16_TOL)):
        with torch.inference_mode():
            want = dpt.load_flax_params(dpt.DPTHybrid(dtype=dtypes[name]), flat).eval()(small)
            got = models[name](small.to(device)).cpu()
        err = float((got - want).abs().max() / want.abs().max())
        results[f"cpu_rel_err_{name}"] = err
        log(f"[dpt] {name} card vs CPU at 2x64x96: {err:.4g} relative (max |logit| "
            f"{float(want.abs().max()):.4f}), want < {tol}")
        if not err < tol:
            raise AssertionError(f"DPT {name} on the card vs the CPU: {err:.3g} relative, "
                                 f"want < {tol}")
    log(f"[dpt] weights, models and CPU checks in {time.perf_counter() - start:.1f} s")

    for batch, h, w in DPT_SHAPES:
        frames = torch.from_numpy(rng.integers(0, 256, (batch, h, w, 3), dtype=np.uint8))
        images = prepare_model_input(frames.to(device), (h, w)).permute(0, 3, 1, 2)
        flops = dpt.dpt_flops((h, w), batch)
        shape = f"{batch}x{h}x{w}"
        logits = {}
        for name, model in models.items():
            with torch.inference_mode():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(device)
                logits[name] = model(images)
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated(device)
                ms, ops = device_profile(lambda: model(images), reps=3, warmup=1)
                loop_ms = events_ms(lambda: model(images), reps=3, warmup=0)
                top = top_kernels(lambda: model(images))
            if not torch.isfinite(logits[name]).all():
                raise AssertionError(f"DPT {name} at {shape}: non-finite logits")
            rate = flops / (ms * 1e-3)
            results[f"{name}_{shape}"] = dict(
                ms=ms, device_ops=ops, loop_ms=loop_ms, frames_per_s=batch / (ms * 1e-3),
                flops=flops, tflops_per_s=rate / 1e12, peak_share=rate / DPT_PEAK_FLOPS[name],
                peak_bytes=peak)
            log(f"[dpt] {name} {shape}: {ms:.4f} ms device ({ops:.0f} kernels), "
                f"{loop_ms:.4f} ms launch loop (events), {batch / (ms * 1e-3):.2f} frames/s; "
                f"{flops / 1e9:.1f} GFLOP, {rate / 1e12:.2f} TFLOP/s = "
                f"{100 * rate / DPT_PEAK_FLOPS[name]:.2f}% of the "
                f"{DPT_PEAK_FLOPS[name] / 1e12:.0f} TFLOP/s {name} data-sheet peak; "
                f"peak device memory {peak} B")
            log(f"[dpt] {name} {shape} top kernels by device time: {top}")
        diff = float(torch.linalg.vector_norm(logits["bf16"] - logits["fp32"])
                     / torch.linalg.vector_norm(logits["fp32"]))
        worst = float((logits["bf16"] - logits["fp32"]).abs().max()
                      / logits["fp32"].abs().max())
        results[f"bf16_vs_fp32_{shape}"] = diff
        log(f"[dpt] bf16 vs fp32 logits at {shape}: {diff:.4g} relative (L2), {worst:.4g} "
            f"(max), want < {DPT_BF16_TOL} (L2); fp32 logits mean "
            f"{float(logits['fp32'].mean()):.4f}, max {float(logits['fp32'].max()):.4f}")
        if not diff < DPT_BF16_TOL:
            raise AssertionError(f"DPT bf16 vs fp32 at {shape}: {diff:.3g}, "
                                 f"want < {DPT_BF16_TOL}")
    del models
    torch.cuda.empty_cache()
    return results


def write_dpt_weights(weights_dir: str) -> None:
    """The check weights from the seed as ``dpt_hybrid_nyu.npz`` in
    ``weights_dir``, the file a user's ``$WEIGHTS_PATH`` holds, with the
    head's last conv mapping its output x to DPT_HEAD_GAIN x +
    DPT_HEAD_OFFSET."""
    from hive_tpu_torch.models import dpt

    flat = dpt.check_flax_params(seed=SEED)
    flat["head_conv3/kernel"] *= np.float32(DPT_HEAD_GAIN)
    flat["head_conv3/bias"] *= np.float32(DPT_HEAD_GAIN)
    flat["head_conv3/bias"] += np.float32(DPT_HEAD_OFFSET)
    np.savez(os.path.join(weights_dir, dpt.WEIGHTS_FILENAME), **flat)


def run_depth_conversion(device, launches, gt_profiling, tmp: str) -> dict:
    """A user's run with ``--estimate_depth`` on phase 7's TUM folder, with
    a weights file in ``$WEIGHTS_PATH`` (``write_dpt_weights``): ``python -m
    hive_tpu_torch`` converts it with DPT-Hybrid on the card and meshes it,
    in this process, nothing patched. Checks 30 uint16 640x480 depth PNGs
    spanning DEPTH_MIN_SPAN_MM or more, each within 1 mm of this script's
    own ``predict_batch`` on the converted frames, the metadata, the launch
    counts, both meshes and the ``get_depth_maps`` stage."""
    from hive_tpu_torch.io import HiveDataset, ImageFolderDataset, load_image
    from hive_tpu_torch.meshing.gltf import load_glb
    from hive_tpu_torch.models.dpt import DPTDepthEstimator
    from hive_tpu_torch.ops.resize import keep_aspect_multiple_of

    tum, out = os.path.join(tmp, "tum"), os.path.join(tmp, "estimated")
    weights_dir = os.path.join(tmp, "weights")
    os.makedirs(weights_dir)
    start = time.perf_counter()
    write_dpt_weights(weights_dir)
    log(f"[depth] wrote the weights file in {time.perf_counter() - start:.1f} s")
    argv = ["hive_tpu_torch", "--dataset_path", tum, "--output_path", out, "--estimate_depth",
            "--key_frame_threshold", "1.0", "--webxr_path", os.path.join(tmp, "webxr_depth"),
            "--log_file", os.path.join(tmp, "pipeline_depth.log")]
    reset_launch_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    with mock.patch.object(sys, "argv", argv), \
            mock.patch.dict(os.environ, {"WEIGHTS_PATH": weights_dir}):
        runpy.run_module("hive_tpu_torch", run_name="__main__", alter_sys=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches["estimated_depth"] = main_launch_counts()
    check_launches("the --estimate_depth run", launches["estimated_depth"], TUM_FRAMES)

    dataset = HiveDataset(out)
    if not dataset.metadata.estimate_depth:
        raise AssertionError("metadata.json does not say estimate_depth")
    depth_paths = dataset.depth_dataset.image_paths
    if [os.path.basename(p) for p in depth_paths] != [f"{i:06d}.png" for i in range(TUM_FRAMES)]:
        raise AssertionError(f"depth maps {depth_paths[:3]}... ({len(depth_paths)})")
    depth = np.stack([load_image(p) for p in depth_paths])
    if depth.dtype != np.uint16 or depth.shape != (TUM_FRAMES, TUM_H, TUM_W):
        raise AssertionError(f"depth maps {depth.dtype} {depth.shape}")
    span = int(depth.max()) - int(depth.min())
    if span < DEPTH_MIN_SPAN_MM:
        raise AssertionError(f"the depth maps span {span} mm, want >= {DEPTH_MIN_SPAN_MM}")

    start = time.perf_counter()
    with mock.patch.dict(os.environ, {"WEIGHTS_PATH": weights_dir}):
        estimator = DPTDepthEstimator(keep_aspect_multiple_of((TUM_H, TUM_W)), device)
    if not estimator.weights_loaded:
        raise AssertionError("the weights file was not loaded")
    want = np.concatenate([(estimator.predict_batch(batch) * 1000.0).astype(np.uint16)
                           for batch in ImageFolderDataset(dataset.path_to_rgb_frames).batches(8)])
    recompute_s = time.perf_counter() - start
    worst = int(np.abs(depth.astype(np.int64) - want.astype(np.int64)).max())
    if worst > 1:
        raise AssertionError(f"depth PNGs differ from predict_batch by up to {worst} mm")

    foreground = load_glb(os.path.join(out, "mesh", "fg.glb"))
    background = next(iter(load_glb(os.path.join(out, "mesh", "bg.glb")).geometry.values()))
    for name in foreground.node_names:
        if not np.isfinite(foreground.geometry[name].vertices).all():
            raise AssertionError(f"fg.glb frame {name}: non-finite vertices")
    if len(background.vertices) == 0 or not np.isfinite(background.vertices).all():
        raise AssertionError("bg.glb holds no (finite) vertices")
    with open(os.path.join(out, "profiling.json")) as f:
        profiling = json.load(f)
    stage = profiling["timing"]["load_dataset"]["get_depth_maps"]

    log(f"[depth] {TUM_FRAMES} frames converted with --estimate_depth and meshed in "
        f"{wall:.1f} s, {profiling['elapsed_time']['per_frame']:.4f} s/frame; get_depth_maps "
        f"{stage:.4f} s; launches {launches['estimated_depth']}; depth {int(depth.min())}-"
        f"{int(depth.max())} mm, within {worst} mm of predict_batch (fresh estimator and "
        f"recompute {recompute_s:.1f} s); fg.glb {len(foreground.node_names)} frames, bg.glb "
        f"{len(background.vertices)} vertices; peak device memory "
        f"{profiling['peak_vram_usage']['allocated']} B")
    ours, theirs = flat_totals(gt_profiling["timing"]), flat_totals(profiling["timing"])
    log(f"[depth] stage s, TUM run with its depth maps | with --estimate_depth: per frame "
        f"{gt_profiling['elapsed_time']['per_frame']:.4f} | "
        f"{profiling['elapsed_time']['per_frame']:.4f}; "
        + "; ".join(f"{k} {ours.get(k, float('nan')):.4f} | {theirs.get(k, float('nan')):.4f}"
                    for k in sorted(set(ours) | set(theirs))))
    return dict(wall_s=wall, per_frame_s=profiling["elapsed_time"]["per_frame"],
                get_depth_maps_s=stage, max_mm_diff=worst, depth_span_mm=span,
                load_dataset=profiling["timing"]["load_dataset"])


# ---------------------------------------------------------------------------
# The weighted person segmenters: Mask R-CNN and the U-Net on the card.
# ---------------------------------------------------------------------------

# The card against the port's CPU, at the CPU tests' canvas (TUM frames
# subsampled to 120 x 160, a 192 x 256 canvas) and at full width (a VGA
# frame, the 832 x 1088 canvas, where cuDNN picks other algorithms), with
# the tolerances the CPU tests hold the port to against hive_tpu
# (tests/test_torch_maskrcnn.py): scores, canvas px, mask probabilities;
# instance ids equal except where a mask's probability lies within
# SEG_MASK_TOL of 0.5.
SEG_SMALL_CANVAS = dict(canvas_min_side=160, canvas_max_side=224)
SEG_SCORE_TOL, SEG_BOX_TOL, SEG_MASK_TOL = 5e-5, 5e-3, 1e-3
# The U-Net's probabilities on the card against the CPU's, at 120 x 160 and
# at 480 x 640 (tests/test_torch_segmentation.py's tolerance against
# hive_tpu).
UNET_CPU_TOL = 1e-4
SEG_BATCH = 8
# The user's run must find an instance in more than half its frames.
SEG_MIN_FRAMES = TUM_FRAMES // 2 + 1
FP32_PEAK_FLOPS = 67e12


def compare_detections(name: str, got: dict, want: dict) -> dict:
    """Validity equal; scores, boxes (valid slots) and masks within the
    SEG_* tolerances; returns the largest differences."""
    if not np.array_equal(got["valid"], want["valid"]):
        raise AssertionError(f"{name}: valid slots differ")
    valid = want["valid"]
    errs = dict(score=float(np.abs(got["scores"] - want["scores"]).max()),
                box=float(np.abs(got["boxes"][valid] - want["boxes"][valid]).max(initial=0.0)),
                mask=float(np.abs(got["masks"] - want["masks"]).max()))
    for key, tol in (("score", SEG_SCORE_TOL), ("box", SEG_BOX_TOL), ("mask", SEG_MASK_TOL)):
        if not errs[key] <= tol:
            raise AssertionError(f"{name}: {key}s differ by {errs[key]:.3g}, want <= {tol}")
    return errs


def compare_instance_ids(name: str, detectors: dict, outs: dict) -> tuple:
    """Each frame's instance ids from the card's and the CPU's ``forward``
    outputs: equal away from the pixels whose mask probability lies within
    SEG_MASK_TOL of 0.5; returns (such pixels, those of them that differ)."""
    near_px = differ_px = 0
    for i in range(len(outs["cpu"]["scores"])):
        want_det = detectors["cpu"].select(outs["cpu"], i)
        got = detectors["card"].paste(detectors["card"].select(outs["card"], i))
        want = detectors["cpu"].paste(want_det)
        near = detectors["cpu"].threshold_distance(want_det) <= SEG_MASK_TOL
        if not np.array_equal(got[~near], want[~near]):
            raise AssertionError(f"{name}: instance ids on the card differ from the CPU's "
                                 f"in frame {i} away from the threshold")
        near_px += int(near.sum())
        differ_px += int((got != want).sum())
    return near_px, differ_px


def over_threshold(out: dict) -> list:
    """Detections over the score threshold in each frame of a forward."""
    from hive_tpu_torch.models.maskrcnn import SCORE_THRESHOLD
    return [int((valid & (scores >= SCORE_THRESHOLD)).sum())
            for valid, scores in zip(out["valid"], out["scores"])]


def conv_algorithms(fn) -> str:
    """Device ms and launches of cuDNN's FFT and Winograd kernels in one
    call of ``fn()`` (one profiler trace), by kernel name."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    found = {"fft": [0, 0.0], "winograd": [0, 0.0]}
    for event in prof.key_averages():
        for key in found:
            if key in event.key.lower():
                found[key][0] += event.count
                found[key][1] += self_device_us(event) / 1e3
    return ", ".join(f"{key} x{n} {ms:.3f} ms" for key, (n, ms) in found.items())


def time_forward(name: str, fn, flops: int, batch: int, device) -> dict:
    """One forward's device ms (profiler) and launch loop (events), frames/s,
    TFLOP/s and its share of the float32 peak, peak device memory, its top
    kernels and cuDNN's FFT / Winograd kernels."""
    with torch.inference_mode():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(device)
        ms, ops = device_profile(fn, reps=3, warmup=1)
        loop_ms = events_ms(fn, reps=3, warmup=0)
        top = top_kernels(fn, count=8)
        algorithms = conv_algorithms(fn)
    rate = flops / (ms * 1e-3)
    log(f"[segment] {name}: {ms:.4f} ms device ({ops:.0f} kernels), {loop_ms:.4f} ms launch "
        f"loop (events), {batch / (ms * 1e-3):.2f} frames/s; {flops / 1e9:.1f} GFLOP, "
        f"{rate / 1e12:.2f} TFLOP/s = {100 * rate / FP32_PEAK_FLOPS:.2f}% of the 67 TFLOP/s "
        f"float32 data-sheet peak; peak device memory {peak} B")
    log(f"[segment] {name} top kernels by device time: {top}")
    log(f"[segment] {name} cuDNN algorithms by kernel name: {algorithms}")
    return dict(ms=ms, device_ops=ops, loop_ms=loop_ms, frames_per_s=batch / (ms * 1e-3),
                flops=flops, tflops_per_s=rate / 1e12, peak_share=rate / FP32_PEAK_FLOPS,
                peak_bytes=peak, conv_algorithms=algorithms)


def check_segmenters(device, tum: str) -> dict:
    """Mask R-CNN and the U-Net at full width on the card, with check
    weights from the seed (``maskrcnn.check_params``,
    ``segmentation.unet_check_params``): the card against the CPU on TUM
    frames subsampled to 120 x 160 (the CPU tests' canvas), then a batch of
    SEG_BATCH VGA frames (Mask R-CNN at its 832 x 1088 canvas) whose first
    frame is held against the CPU's result for it alone, and timed."""
    from hive_tpu_torch.io import load_image
    from hive_tpu_torch.models import maskrcnn, segmentation

    start = time.perf_counter()
    names = sorted(os.listdir(os.path.join(tum, "rgb")))[TUM_PRIMED:TUM_PRIMED + SEG_BATCH]
    frames = np.stack([load_image(os.path.join(tum, "rgb", name)) for name in names])
    small = np.ascontiguousarray(frames[:3, ::4, ::4])
    flat = maskrcnn.check_params(SEED)
    models = {"card": maskrcnn.load_params(flat, device), "cpu": maskrcnn.load_params(flat, "cpu")}
    detectors = {k: maskrcnn.MaskRCNNDetector(m, small.shape[1:3], **SEG_SMALL_CANVAS)
                 for k, m in models.items()}
    outs = {k: d.forward(small) for k, d in detectors.items()}
    results = {"maskrcnn_card_vs_cpu": compare_detections("Mask R-CNN card vs CPU", outs["card"],
                                                          outs["cpu"])}
    near_px, differ_px = compare_instance_ids("Mask R-CNN", detectors, outs)
    log(f"[segment] Mask R-CNN card vs CPU at {small.shape[1]}x{small.shape[2]}: "
        f"{results['maskrcnn_card_vs_cpu']}; detections over 0.5 {over_threshold(outs['cpu'])}; "
        f"instance ids equal away from 0.5 ({near_px} px within {SEG_MASK_TOL}, {differ_px} of "
        f"them differ)")

    # Full width: a batch of VGA frames in the 832 x 1088 canvas; its first
    # frame against the CPU's forward of that frame alone.
    detectors = {k: maskrcnn.MaskRCNNDetector(m, frames.shape[1:3]) for k, m in models.items()}
    detector = detectors["card"]
    batch = detector.forward(frames)
    single = detector.forward(frames[:1])
    results["maskrcnn_batch_vs_single"] = compare_detections(
        "Mask R-CNN batch vs single frame", {k: v[:1] for k, v in batch.items()}, single)
    if not all(np.isfinite(v).all() for v in batch.values() if v.dtype != bool):
        raise AssertionError("Mask R-CNN at full width: non-finite outputs")
    cpu_start = time.perf_counter()
    outs = {"card": {k: v[:1] for k, v in batch.items()}, "cpu": detectors["cpu"].forward(frames[:1])}
    cpu_s = time.perf_counter() - cpu_start
    results["maskrcnn_full_card_vs_cpu"] = compare_detections(
        "Mask R-CNN card batch vs CPU at full width", outs["card"], outs["cpu"])
    near_px, differ_px = compare_instance_ids("Mask R-CNN at full width", detectors, outs)
    log(f"[segment] Mask R-CNN card (slot 0 of the batch of {len(frames)}) vs CPU at "
        f"{frames.shape[1]}x{frames.shape[2]} ({detector.canvas_hw[0]}x{detector.canvas_hw[1]} "
        f"canvas; CPU forward {cpu_s:.1f} s): {results['maskrcnn_full_card_vs_cpu']}; detections "
        f"over 0.5 {over_threshold(outs['cpu'])}; instance ids equal away from 0.5 ({near_px} px "
        f"within {SEG_MASK_TOL}, {differ_px} of them differ)")
    del models["cpu"], detectors, outs
    images = detector.canvas(torch.from_numpy(frames).to(device))
    count = len(frames)
    shape = f"{count}x{detector.canvas_hw[0]}x{detector.canvas_hw[1]}"
    results[f"maskrcnn_{shape}"] = time_forward(
        f"Mask R-CNN fp32 {shape}", lambda: models["card"](images, detector.scaled_hw),
        maskrcnn.maskrcnn_flops(detector.canvas_hw, count), count, device)
    log(f"[segment] Mask R-CNN at full width: detections over 0.5 {over_threshold(batch)}; "
        f"batch vs single frame {results['maskrcnn_batch_vs_single']}; weights, models and "
        f"checks in {time.perf_counter() - start:.1f} s")
    del models, detector, images
    torch.cuda.empty_cache()

    # The U-Net.
    with tempfile.TemporaryDirectory(prefix="hive_unet_") as tmp:
        path = os.path.join(tmp, "person_unet.npz")
        np.savez(path, **segmentation.unet_check_params(SEED))
        unets = {"card": segmentation._UNetBackend(path, device),
                 "cpu": segmentation._UNetBackend(path, "cpu")}
    got, want = (unets[k].person_probabilities(small).cpu().numpy() for k in ("card", "cpu"))
    err = float(np.abs(got - want).max())
    results["unet_card_vs_cpu"] = err
    log(f"[segment] U-Net card vs CPU at {small.shape[1]}x{small.shape[2]}: probabilities "
        f"within {err:.3g} (want <= {UNET_CPU_TOL}), {float((want > 0.5).mean()):.3f} over 0.5")
    if not err <= UNET_CPU_TOL:
        raise AssertionError(f"U-Net card vs CPU: {err:.3g}, want <= {UNET_CPU_TOL}")
    unet = unets["card"]
    inputs = unet.inputs(frames)
    probability = unet.person_probabilities(frames)
    if not torch.isfinite(probability).all() or probability.shape != frames.shape[:3]:
        raise AssertionError(f"U-Net at full width: {tuple(probability.shape)}, finite "
                             f"{bool(torch.isfinite(probability).all())}")
    # Full width: the batch's first frame against the CPU's for it alone.
    want = unets["cpu"].person_probabilities(frames[:1]).numpy()
    err = float(np.abs(probability[:1].cpu().numpy() - want).max())
    results["unet_full_card_vs_cpu"] = err
    log(f"[segment] U-Net card (slot 0 of the batch of {len(frames)}) vs CPU at "
        f"{frames.shape[1]}x{frames.shape[2]}: probabilities within {err:.3g} (want <= "
        f"{UNET_CPU_TOL}), {float((want > 0.5).mean()):.3f} over 0.5")
    if not err <= UNET_CPU_TOL:
        raise AssertionError(f"U-Net card vs CPU at full width: {err:.3g}, want <= "
                             f"{UNET_CPU_TOL}")
    shape = "x".join(str(n) for n in frames.shape[:3])
    results[f"unet_{shape}"] = time_forward(
        f"U-Net fp32 {shape}", lambda: unet.model(inputs),
        segmentation.unet_flops(tuple(inputs.shape[2:]), count), count, device)
    del unets, unet, inputs
    torch.cuda.empty_cache()
    return results


def run_segmented_conversion(device, launches, gt_profiling, tmp: str) -> dict:
    """A user's run with Mask R-CNN weights: the check weights written as
    ``$WEIGHTS_PATH/maskrcnn_coco.npz``, then ``python -m hive_tpu_torch``
    converts phase 7's TUM folder (the masks from Mask R-CNN on the card)
    and meshes it, in this process, nothing patched. Checks 30 mask PNGs
    equal to this script's own ``predict_batch`` on the converted frames,
    an instance in more than half the frames, the launch counts, both
    meshes, and logs the stages beside phase 7's motion-mask run."""
    from hive_tpu_torch.io import HiveDataset, ImageFolderDataset
    from hive_tpu_torch.meshing.gltf import load_glb
    from hive_tpu_torch.models import maskrcnn
    from hive_tpu_torch.models.segmentation import PersonSegmenter

    tum, out = os.path.join(tmp, "tum"), os.path.join(tmp, "segmented")
    weights_dir = os.path.join(tmp, "seg_weights")
    os.makedirs(weights_dir)
    np.savez(os.path.join(weights_dir, maskrcnn.WEIGHTS_FILENAME), **maskrcnn.check_params(SEED))
    argv = ["hive_tpu_torch", "--dataset_path", tum, "--output_path", out,
            "--key_frame_threshold", "1.0", "--webxr_path", os.path.join(tmp, "webxr_seg"),
            "--log_file", os.path.join(tmp, "pipeline_seg.log")]
    reset_launch_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    with mock.patch.object(sys, "argv", argv), \
            mock.patch.dict(os.environ, {"WEIGHTS_PATH": weights_dir}):
        runpy.run_module("hive_tpu_torch", run_name="__main__", alter_sys=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches["segmented"] = main_launch_counts()
    check_launches("the Mask R-CNN run", launches["segmented"], TUM_FRAMES)

    dataset = HiveDataset(out)
    card = np.stack([dataset.mask_dataset[i] for i in range(TUM_FRAMES)])
    start = time.perf_counter()
    with mock.patch.dict(os.environ, {"WEIGHTS_PATH": weights_dir}):
        segmenter = PersonSegmenter(device=device)
    if segmenter.backend != "maskrcnn":
        raise AssertionError(f"the weights file selected the {segmenter.backend} backend")
    want = np.stack([m for batch in ImageFolderDataset(dataset.path_to_rgb_frames).batches(8)
                     for m in segmenter.predict_batch(batch)])
    recompute_s = time.perf_counter() - start
    if card.shape != want.shape or not np.array_equal(card, want):
        raise AssertionError(f"mask PNGs differ from predict_batch at "
                             f"{int((card != want).sum())} pixels")
    instances = card.reshape(TUM_FRAMES, -1).max(axis=1)
    if int((instances > 0).sum()) < SEG_MIN_FRAMES:
        raise AssertionError(f"instances a frame {instances.tolist()}: want one in at least "
                             f"{SEG_MIN_FRAMES} frames")

    foreground = load_glb(os.path.join(out, "mesh", "fg.glb"))
    background = next(iter(load_glb(os.path.join(out, "mesh", "bg.glb")).geometry.values()))
    for name in foreground.node_names:
        if not np.isfinite(foreground.geometry[name].vertices).all():
            raise AssertionError(f"fg.glb frame {name}: non-finite vertices")
    if len(background.vertices) == 0 or not np.isfinite(background.vertices).all():
        raise AssertionError("bg.glb holds no (finite) vertices")
    with open(os.path.join(out, "profiling.json")) as f:
        profiling = json.load(f)
    stage = profiling["timing"]["load_dataset"]["create_instance_segmentation_masks"]
    mog2 = gt_profiling["timing"]["load_dataset"]["create_instance_segmentation_masks"]

    log(f"[segment] {TUM_FRAMES} frames converted with Mask R-CNN masks and meshed in {wall:.1f} "
        f"s, {profiling['elapsed_time']['per_frame']:.4f} s/frame; "
        f"create_instance_segmentation_masks {stage:.4f} s (motion masks, phase 7: {mog2:.4f} "
        f"s); launches {launches['segmented']}; instances a frame {instances.tolist()} "
        f"({float((card > 0).mean()):.3f} of the pixels), the PNGs "
        f"equal predict_batch (fresh segmenter and recompute {recompute_s:.1f} s); fg.glb "
        f"{len(foreground.node_names)} frames, bg.glb {len(background.vertices)} vertices; "
        f"peak device memory {profiling['peak_vram_usage']['allocated']} B")
    ours, theirs = flat_totals(gt_profiling["timing"]), flat_totals(profiling["timing"])
    log(f"[segment] stage s, TUM run with motion masks | with Mask R-CNN masks: per frame "
        f"{gt_profiling['elapsed_time']['per_frame']:.4f} | "
        f"{profiling['elapsed_time']['per_frame']:.4f}; "
        + "; ".join(f"{k} {ours.get(k, float('nan')):.4f} | {theirs.get(k, float('nan')):.4f}"
                    for k in sorted(set(ours) | set(theirs))))
    return dict(wall_s=wall, per_frame_s=profiling["elapsed_time"]["per_frame"],
                masks_s=stage, motion_masks_s=mog2, instances=instances.tolist(),
                load_dataset=profiling["timing"]["load_dataset"])


# ---------------------------------------------------------------------------
# Inpainting: big-lama on the card, TELEA and the mask dilation on the host.
# ---------------------------------------------------------------------------

# The card's generator against the CPU's, with the check weights, over the
# hole, two frames of 60 x 84 (the inpainter pads them to 64 x 88). float32:
# max |difference| within the CPU parity test's tolerance against hive_tpu
# (tests/test_torch_lama.py), measured 1.4e-6 on an H100 80GB HBM3 (700 W).
LAMA_F32_TOL = 1e-5
# bf16 as the CLI runs it: (max, mean) |difference|. The card's bf16
# convolutions round one output in 10^3-10^4 to the other bf16 value than
# the CPU's do (the leaf check below), and one such rounding in the Fourier
# unit's spectrum moves the whole map through irfft2: measured 0.0075 max,
# 0.0014 mean on an H100 80GB HBM3 (700 W), with cuFFT and with the CPU's
# FFT alike, about as far as bf16 lies from float32 on the CPU (0.0085
# max). So the network's output is held to LAMA_BF16_TOL, and to the CPU's
# float32 no further than LAMA_BF16_ERROR_RATIO times the CPU's bf16; the
# dtype flow and each layer's arithmetic are held by the leaf check.
LAMA_BF16_TOL = (0.02, 0.003)
LAMA_BF16_ERROR_RATIO = 2.0
# The leaf check: each convolution, transposed convolution and folded norm
# of the card's bf16 generator fed the CPU's input to it, against the CPU's
# output. Per leaf, the share of outputs that differ at all, and the
# largest |difference| over the map's largest |value| (two bf16 ulps).
# Measured: convolutions 0.01-0.13% by one bf16 ulp, norms none. A leaf
# run in another dtype differs almost everywhere.
LAMA_LEAF_SHARE = 0.01
LAMA_LEAF_REL = 2.0 ** -6
# The dtype of each leaf's output in bf16, as the reference's: convolutions
# give bf16, the folded norms' float32 parameters promote to float32.
LAMA_BF16_LEAF_DTYPES = {"Conv": "bfloat16", "ConvTranspose3x3": "bfloat16",
                         "FoldedBN": "float32"}
# Faults planted in the card's bf16 generator, each of which the leaf
# check must catch.
LAMA_FAULTS = ("fourier_conv_fp32", "bn_bf16")
LAMA_SMALL = (2, 60, 84)
LAMA_BATCH = 8
# The user's run fills the dilated blob's depth from the wall at 2 m.
INPAINT_WALL_MM = 2000
INPAINT_DEPTH_TOL_MM = 5


def fft_kernels(fn) -> tuple:
    """(launches, device ms) of the kernels named ``*fft*`` in one call of
    ``fn()`` (one profiler trace): cuFFT's, and cuDNN's FFT convolutions."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if "fft" in e.key.lower()]
    return sum(e.count for e in events), sum(self_device_us(e) for e in events) / 1e3


def lama_leaf_check(card, cpu, frames, masks) -> dict:
    """Each leaf (convolution, transposed convolution, folded norm) of the
    card inpainter's generator fed the input that the same leaf of the
    CPU's got in one forward of ``frames``, against the CPU leaf's output.
    By leaf kind: the largest share of outputs that differ, the largest
    |difference| over the map's largest |value|, the dtypes of the card's
    and the CPU's outputs, and whether it breaks LAMA_LEAF_SHARE,
    LAMA_LEAF_REL or LAMA_BF16_LEAF_DTYPES."""
    from hive_tpu_torch.models import lama

    seen = {}
    handles = [module.register_forward_hook(
        lambda _, args, out, name=name: seen.__setitem__(name, (args[0], out)))
        for name, module in cpu.model.named_modules()
        if isinstance(module, (lama.Conv, lama.ConvTranspose3x3, lama.FoldedBN))]
    try:
        cpu.forward(frames, masks)
    finally:
        for handle in handles:
            handle.remove()
    modules = dict(card.model.named_modules())
    kinds = {}
    with torch.inference_mode():
        for name, (x, want) in seen.items():
            got = modules[name](x.to(card.device)).cpu()
            diff = (got.float() - want.float()).abs()
            kind = kinds.setdefault(type(modules[name]).__name__,
                                    dict(leaves=0, share=0.0, rel=0.0, card=set(), cpu=set()))
            kind["leaves"] += 1
            kind["share"] = max(kind["share"], float((diff > 0).float().mean()))
            kind["rel"] = max(kind["rel"], float(diff.max() / want.float().abs().max()))
            kind["card"].add(str(got.dtype)[6:])
            kind["cpu"].add(str(want.dtype)[6:])
    for name, kind in kinds.items():
        kind["card"], kind["cpu"] = sorted(kind["card"]), sorted(kind["cpu"])
        kind["fails"] = bool(kind["share"] > LAMA_LEAF_SHARE or kind["rel"] > LAMA_LEAF_REL
                             or kind["card"] != [LAMA_BF16_LEAF_DTYPES[name]]
                             or kind["cpu"] != kind["card"])
    return kinds


def plant_lama_fault(inpainter, fault: str):
    """``fourier_conv_fp32``: each Fourier unit's 1x1 conv runs in float32
    (the reference's runs in bf16). ``bn_bf16``: each folded norm computes
    in its input's dtype, bf16 after a conv (the reference's promotes to
    float32)."""
    from hive_tpu_torch.models import lama

    for module in inpainter.model.modules():
        if fault == "fourier_conv_fp32" and isinstance(module, lama.FourierUnit):
            module.conv.dtype = torch.float32
        elif fault == "bn_bf16" and isinstance(module, lama.FoldedBN):
            module.forward = lambda x, bn=module: torch.addcmul(
                bn.bias.to(x.dtype)[:, None, None], x, bn.scale.to(x.dtype)[:, None, None])
    return inpainter


def check_lama_small(device, flat) -> tuple:
    """The card's generator against the CPU's on LAMA_SMALL frames (not a
    multiple of 8: the inpainter pads them), over the hole: float32 within
    LAMA_F32_TOL; bf16 within LAMA_BF16_TOL and LAMA_BF16_ERROR_RATIO;
    both outputs float32; every leaf of the bf16 generator within the leaf
    check (:func:`lama_leaf_check`). Then each of LAMA_FAULTS planted in
    the card's bf16 generator must fail the leaf check; whether the
    network's tolerances catch it too is logged. Returns the readings and
    the bf16 inpainter."""
    from hive_tpu_torch.models import lama

    rng = np.random.default_rng(SEED)
    b, h, w = LAMA_SMALL
    frames = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    masks = np.zeros((b, h, w), np.uint8)
    masks[:, h // 4:3 * h // 4, w // 4:3 * w // 4] = 255
    hole = np.broadcast_to(masks[:, None] > 127, (b, 3, h, w))
    results, outs, inpainters, cpus = {}, {}, {}, {}
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        inpainters[name] = lama.LamaInpainter(device, dtype=dtype, params=flat)
        cpus[name] = lama.LamaInpainter("cpu", dtype=dtype, params=flat)
        card_out = inpainters[name].forward(frames, masks)
        cpu_out = cpus[name].forward(frames, masks)
        if card_out.dtype != torch.float32 or cpu_out.dtype != torch.float32:
            raise AssertionError(f"LaMa {name} output: card {card_out.dtype}, CPU {cpu_out.dtype}")
        outs[name] = card_out.cpu().numpy()[hole], cpu_out.numpy()[hole]
    card_f32, cpu_f32 = outs["fp32"]
    card_bf16, cpu_bf16 = outs["bf16"]
    err = {"fp32 card vs CPU": np.abs(card_f32 - cpu_f32),
           "bf16 card vs CPU": np.abs(card_bf16 - cpu_bf16),
           "bf16 card vs CPU fp32": np.abs(card_bf16 - cpu_f32),
           "bf16 CPU vs CPU fp32": np.abs(cpu_bf16 - cpu_f32)}
    results["cpu_err"] = {k: dict(max=float(v.max()), mean=float(v.mean())) for k, v in err.items()}
    results["leaves"] = lama_leaf_check(inpainters["bf16"], cpus["bf16"], frames, masks)
    log(f"[lama] card vs CPU at {b}x{h}x{w} over the hole (max, mean): "
        + "; ".join(f"{k} {v.max():.4g}, {v.mean():.4g}" for k, v in err.items())
        + f"; want fp32 <= {LAMA_F32_TOL}, bf16 <= {LAMA_BF16_TOL} and the card's bf16 within "
        f"{LAMA_BF16_ERROR_RATIO}x the CPU's bf16 error; outputs float32; CPU fill "
        f"{float(cpu_f32.min()):.4f}-{float(cpu_f32.max()):.4f}")
    log(f"[lama] bf16 leaves fed the CPU's inputs (want share <= {LAMA_LEAF_SHARE}, "
        f"|difference| <= {LAMA_LEAF_REL} of the map's max, dtypes {LAMA_BF16_LEAF_DTYPES}): "
        + json.dumps(results["leaves"]))

    def network_fails(e, e_f32):
        ratio, reference = LAMA_BF16_ERROR_RATIO, err["bf16 CPU vs CPU fp32"]
        return bool(e.max() > LAMA_BF16_TOL[0] or e.mean() > LAMA_BF16_TOL[1]
                    or e_f32.max() > ratio * reference.max()
                    or e_f32.mean() > ratio * reference.mean())

    if (err["fp32 card vs CPU"].max() > LAMA_F32_TOL
            or network_fails(err["bf16 card vs CPU"], err["bf16 card vs CPU fp32"])
            or any(kind["fails"] for kind in results["leaves"].values())):
        raise AssertionError(f"LaMa on the card vs the CPU: {results['cpu_err']}, leaves "
                             f"{results['leaves']}")

    for fault in LAMA_FAULTS:
        faulty = plant_lama_fault(lama.LamaInpainter(device, dtype=torch.bfloat16, params=flat),
                                  fault)
        out = faulty.forward(frames, masks)
        if out.dtype != torch.float32:
            raise AssertionError(f"LaMa with {fault}: {out.dtype} output")
        out = out.cpu().numpy()[hole]
        e_card, e_f32 = np.abs(out - cpu_bf16), np.abs(out - cpu_f32)
        leaves = lama_leaf_check(faulty, cpus["bf16"], frames, masks)
        caught = dict(network=network_fails(e_card, e_f32),
                      leaves=sorted(name for name, kind in leaves.items() if kind["fails"]))
        results[f"fault_{fault}"] = dict(
            network=dict(max=float(e_card.max()), mean=float(e_card.mean())),
            network_vs_cpu_fp32=dict(max=float(e_f32.max()), mean=float(e_f32.mean())),
            leaves={name: kind for name, kind in leaves.items() if kind["fails"]}, caught=caught)
        log(f"[lama] planted fault {fault}: bf16 vs CPU {e_card.max():.4g}, "
            f"{e_card.mean():.4g} (vs the CPU's fp32 {e_f32.max():.4g}, {e_f32.mean():.4g}); "
            f"caught by {caught}; failing leaves {json.dumps(results[f'fault_{fault}']['leaves'])}")
        if not caught["leaves"]:
            raise AssertionError(f"LaMa planted fault {fault} passes the leaf check")
        del faulty
    return results, inpainters["bf16"]


def check_lama(device, tum: str) -> dict:
    """big-lama at full width (ngf 64, 3 downsamples, 18 FFC blocks) with
    the check weights from the seed: the card against the CPU on small
    frames (:func:`check_lama_small`); then a batch of LAMA_BATCH of phase
    7's VGA frames, each with a 255-valued hole over 25% of it, in bf16 as
    the CLI runs it: each frame held to its forward alone (LAMA_BF16_TOL),
    known pixels passed through exactly, and timed: device ms, launch loop,
    frames/s, ``lama_flops``, TFLOP/s and its share of the bf16 peak, peak
    device memory, the top kernels and the FFT kernels' share."""
    from hive_tpu_torch.io import load_image
    from hive_tpu_torch.models import lama

    start = time.perf_counter()
    results, inpainter = check_lama_small(device, lama.check_params(SEED))
    log(f"[lama] weights, models and CPU checks in {time.perf_counter() - start:.1f} s")

    names = sorted(os.listdir(os.path.join(tum, "rgb")))[:LAMA_BATCH]
    frames = np.stack([load_image(os.path.join(tum, "rgb", name)) for name in names])
    masks = np.zeros((LAMA_BATCH, TUM_H, TUM_W), np.uint8)
    for i in range(LAMA_BATCH):
        masks[i, TUM_H // 4:3 * TUM_H // 4, TUM_W // 4 + 8 * i:3 * TUM_W // 4 + 8 * i] = 255
    batch = inpainter.forward(frames, masks).cpu().numpy()
    if batch.dtype != np.float32 or not np.isfinite(batch).all():
        raise AssertionError(f"LaMa at full width: {batch.dtype} output, or not finite")
    hole = np.broadcast_to(masks[:, None] > 127, batch.shape)
    image = frames.transpose(0, 3, 1, 2).astype(np.float32) / 255.0
    if not np.array_equal(batch[~hole], image[~hole]):
        raise AssertionError("LaMa changed known pixels")
    worst, mean = 0.0, 0.0
    for i in range(LAMA_BATCH):
        single = inpainter.forward(frames[i:i + 1], masks[i:i + 1]).cpu().numpy()[0]
        diff = np.abs(single - batch[i])[hole[i]]
        worst, mean = max(worst, float(diff.max())), max(mean, float(diff.mean()))
    atol, mean_tol = LAMA_BF16_TOL
    results["batch_vs_single"] = dict(max=worst, mean=mean)
    log(f"[lama] bf16 {LAMA_BATCH}x{TUM_H}x{TUM_W}, a 255-valued hole over "
        f"{float(hole.mean()):.3f} of each frame: known pixels passed through exactly; each "
        f"frame vs its forward alone within {worst:.4g} (max), {mean:.4g} (mean of a frame's "
        f"hole, the worst frame), want <= {atol}, {mean_tol}; fill "
        f"{float(batch[hole].min()):.4f}-{float(batch[hole].max()):.4f}, std "
        f"{float(batch[hole].std()):.4f}")
    if worst > atol or mean > mean_tol:
        raise AssertionError(f"LaMa batch vs single frame: {worst:.3g} max, {mean:.3g} mean")

    image, hole = inpainter.inputs(frames, masks)
    model = inpainter.model
    flops = lama.lama_flops((TUM_H, TUM_W), LAMA_BATCH)
    with torch.inference_mode():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        model(image, hole)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(device)
        ms, ops = device_profile(lambda: model(image, hole), reps=3, warmup=1)
        loop_ms = events_ms(lambda: model(image, hole), reps=3, warmup=0)
        top = top_kernels(lambda: model(image, hole), count=8)
        fft_count, fft_ms = fft_kernels(lambda: model(image, hole))
        started = time.perf_counter()
        inpainter.inpaint_batch(frames, masks)
        inpaint_s = time.perf_counter() - started
    rate = flops / (ms * 1e-3)
    shape = f"{LAMA_BATCH}x{TUM_H}x{TUM_W}"
    results[f"bf16_{shape}"] = dict(
        ms=ms, device_ops=ops, loop_ms=loop_ms, frames_per_s=LAMA_BATCH / (ms * 1e-3),
        flops=flops, tflops_per_s=rate / 1e12, peak_share=rate / DPT_PEAK_FLOPS["bf16"],
        peak_bytes=peak, fft_launches=fft_count, fft_ms=fft_ms, inpaint_batch_s=inpaint_s)
    log(f"[lama] bf16 {shape}: {ms:.4f} ms device ({ops:.0f} kernels), {loop_ms:.4f} ms launch "
        f"loop (events), {LAMA_BATCH / (ms * 1e-3):.2f} frames/s; {flops / 1e9:.1f} GFLOP "
        f"(lama_flops: the convolutions, the transposed ones without the reference's zero "
        f"terms), {rate / 1e12:.2f} TFLOP/s = {100 * rate / DPT_PEAK_FLOPS['bf16']:.2f}% of the "
        f"989 TFLOP/s bf16 data-sheet peak; peak device memory {peak} B; FFT kernels x{fft_count} "
        f"{fft_ms:.4f} ms ({100 * fft_ms / ms:.1f}% of the device time); inpaint_batch "
        f"(host padding, transfers, uint8 out) {inpaint_s:.3f} s")
    log(f"[lama] bf16 {shape} top kernels by device time: {top}")
    del inpainter, model, image, hole
    torch.cuda.empty_cache()
    return results


def run_inpainting_conversion(device, launches, gt_profiling, tmp: str) -> dict:
    """A user's run with ``--inpainting_mode 2`` (LaMa for RGB, TELEA for
    depth) on phase 7's TUM folder, the check weights written as
    ``$WEIGHTS_PATH/big-lama.npz``, in this process, nothing patched.
    Checks the three inpainted folders (30 files each, the masks there
    blacked out), the RGB frames against this script's own
    ``LamaInpainter`` on the converted frames and dilated masks, the
    dilated blob's depth filled from the 2 m wall where the mask covers the
    blob, the native TELEA against
    a recompute on one frame, the launch counts and both meshes, and logs
    the ``inpainting`` stage beside phase 7's stages."""
    from hive_tpu_torch.image_codecs import CV2_JPEG_QUALITY, encode_jpeg
    from hive_tpu_torch.image_processing import TELEA_RADIUS, dilate_ids, inpaint_telea
    from hive_tpu_torch.io import HiveDataset, load_image
    from hive_tpu_torch.meshing.gltf import load_glb
    from hive_tpu_torch.models import lama

    tum, out = os.path.join(tmp, "tum"), os.path.join(tmp, "inpainted")
    weights_dir = os.path.join(tmp, "lama_weights")
    os.makedirs(weights_dir)
    flat = lama.check_params(SEED)
    np.savez(os.path.join(weights_dir, lama.WEIGHTS_FILENAME), **flat)
    argv = ["hive_tpu_torch", "--dataset_path", tum, "--output_path", out, "--inpainting_mode",
            "2", "--key_frame_threshold", "1.0", "--webxr_path",
            os.path.join(tmp, "webxr_inpaint"), "--log_file",
            os.path.join(tmp, "pipeline_inpaint.log")]
    reset_launch_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    with mock.patch.object(sys, "argv", argv), \
            mock.patch.dict(os.environ, {"WEIGHTS_PATH": weights_dir}):
        runpy.run_module("hive_tpu_torch", run_name="__main__", alter_sys=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches["inpainted"] = main_launch_counts()
    check_launches("the --inpainting_mode 2 run", launches["inpainted"], TUM_FRAMES)

    dataset = HiveDataset(out)
    if not dataset.has_inpainted_frame_data:
        raise AssertionError("the run wrote no inpainted frames")
    folders = {}
    for folder in ("rgb_inpainted", "depth_inpainted", "mask_inpainted"):
        folders[folder] = sorted(os.listdir(os.path.join(out, folder)))
        if len(folders[folder]) != TUM_FRAMES:
            raise AssertionError(f"{folder} holds {len(folders[folder])} files")
    for name in folders["mask_inpainted"]:
        if load_image(os.path.join(out, "mask_inpainted", name)).any():
            raise AssertionError(f"mask_inpainted/{name} is not blacked out")

    masks = np.stack([dilate_ids(dataset.mask_dataset[i]) for i in range(TUM_FRAMES)])
    frames = np.stack([dataset.rgb_dataset[i] for i in range(TUM_FRAMES)])
    start = time.perf_counter()
    inpainter = lama.LamaInpainter(device, params=flat)
    want = np.concatenate([inpainter.inpaint_batch(frames[i:i + lama.BATCH_SIZE],
                                                   masks[i:i + lama.BATCH_SIZE])
                           for i in range(0, TUM_FRAMES, lama.BATCH_SIZE)])
    for i, name in enumerate(folders["rgb_inpainted"]):
        with open(os.path.join(out, "rgb_inpainted", name), "rb") as f:
            if f.read() != encode_jpeg(want[i], quality=CV2_JPEG_QUALITY):
                raise AssertionError(f"rgb_inpainted/{name} differs from LamaInpainter's frame")
    recompute_s = time.perf_counter() - start
    lama_hole_px = int((masks > 127).sum())

    depth = np.stack([load_image(p) for p in dataset.depth_dataset.image_paths])
    filled = np.stack([load_image(os.path.join(out, "depth_inpainted", name))
                       for name in folders["depth_inpainted"]])
    if not np.array_equal(filled[masks == 0], depth[masks == 0]):
        raise AssertionError("depth_inpainted changed depth outside the dilated masks")
    # After priming, in each frame whose dilated mask covers the whole blob
    # (TELEA then sees only the wall), the fill must be the wall's depth.
    # Where part of the blob lies outside the mask, TELEA rightly draws
    # from it too.
    covered, fills = [], {}
    for i in range(TUM_PRIMED, TUM_FRAMES):
        grown, blob = masks[i] > 0, depth[i] < INPAINT_WALL_MM - 250
        fill = filled[i][grown].astype(np.int64)
        fills[i] = (int(fill.min()), int(fill.max())) if fill.size else None
        if blob.any() and not (blob & ~grown).any():
            covered.append(i)
    worst = max((max(abs(lo - INPAINT_WALL_MM), abs(hi - INPAINT_WALL_MM))
                 for lo, hi in (fills[i] for i in covered)), default=None)
    fill_log = (f"{len(covered)} of {TUM_FRAMES - TUM_PRIMED} frames after priming have the "
                f"whole blob under the dilated mask, their fill within {worst} mm of the wall; "
                f"fill (min, max) mm a frame: {fills}")
    if len(covered) < (TUM_FRAMES - TUM_PRIMED) // 2 or worst > INPAINT_DEPTH_TOL_MM:
        raise AssertionError(f"depth fill: {fill_log}; want half the frames covered, within "
                             f"{INPAINT_DEPTH_TOL_MM} mm")
    frame = TUM_PRIMED
    start = time.perf_counter()
    again = inpaint_telea(depth[frame], masks[frame], TELEA_RADIUS)
    telea_s = time.perf_counter() - start
    if not np.array_equal(again, filled[frame]):
        raise AssertionError(f"depth_inpainted frame {frame} differs from inpaint_telea's")

    foreground = load_glb(os.path.join(out, "mesh", "fg.glb"))
    background = next(iter(load_glb(os.path.join(out, "mesh", "bg.glb")).geometry.values()))
    for name in foreground.node_names:
        if not np.isfinite(foreground.geometry[name].vertices).all():
            raise AssertionError(f"fg.glb frame {name}: non-finite vertices")
    if len(background.vertices) == 0 or not np.isfinite(background.vertices).all():
        raise AssertionError("bg.glb holds no (finite) vertices")
    with open(os.path.join(out, "profiling.json")) as f:
        profiling = json.load(f)
    stage = profiling["timing"]["load_dataset"]["inpainting"]

    log(f"[inpaint] {TUM_FRAMES} frames converted with --inpainting_mode 2 and meshed in "
        f"{wall:.1f} s, {profiling['elapsed_time']['per_frame']:.4f} s/frame; inpainting "
        f"{stage:.4f} s; launches {launches['inpainted']}; dilated masks over "
        f"{float((masks > 0).mean()):.4f} of the pixels, {lama_hole_px} of them > 127 (LaMa's "
        f"hole: the instance ids are 1, the reference's threshold, ROADMAP Queue 3 item 3); "
        f"rgb_inpainted equals LamaInpainter's frames as quality-95 JPEGs (fresh inpainter "
        f"and recompute {recompute_s:.1f} s); {fill_log}; frame {frame}'s depth equals "
        f"inpaint_telea's ({telea_s:.3f} s); fg.glb {len(foreground.node_names)} frames, "
        f"bg.glb {len(background.vertices)} vertices; peak device memory "
        f"{profiling['peak_vram_usage']['allocated']} B")
    ours, theirs = flat_totals(gt_profiling["timing"]), flat_totals(profiling["timing"])
    log(f"[inpaint] stage s, TUM run without inpainting | with --inpainting_mode 2: per frame "
        f"{gt_profiling['elapsed_time']['per_frame']:.4f} | "
        f"{profiling['elapsed_time']['per_frame']:.4f}; "
        + "; ".join(f"{k} {ours.get(k, float('nan')):.4f} | {theirs.get(k, float('nan')):.4f}"
                    for k in sorted(set(ours) | set(theirs))))
    return dict(wall_s=wall, per_frame_s=profiling["elapsed_time"]["per_frame"],
                inpainting_s=stage, covered_frames=covered, depth_fill_mm=worst,
                lama_hole_px=lama_hole_px, telea_frame_s=telea_s,
                load_dataset=profiling["timing"]["load_dataset"])


# ---------------------------------------------------------------------------
# The pose optimiser's training loop on the card.
# ---------------------------------------------------------------------------

# pose-optimise: a 10 s TUM clip at 30 fps (fx = 525, VGA), a handheld sweep
# in front of a wall, POSE_PER_PAIR noisy correspondences a hierarchical
# pair (593 pairs), the ground truth perturbed by a smooth drift of up to
# POSE_PERTURB_M and POSE_PERTURB_DEG.
POSE_FRAMES, POSE_H, POSE_W, POSE_FOCAL = 300, 480, 640, 525.0
POSE_LANDMARKS, POSE_PER_PAIR, POSE_NOISE_PX = 8000, 300, 0.5
POSE_PERTURB_M, POSE_PERTURB_DEG = 0.05, 1.0
# The CPU tests' tolerances (tests/test_torch_pose.py): a 25-epoch chunk's
# losses (relative) and parameters, and a float64 run's trajectory.
POSE_LOSS_RTOL, POSE_CHUNK_TOL, POSE_RUN_TOL = 1e-5, 1e-6, 1e-4
# pose-optimise's float32 gradients on the card against the CPU's float64,
# as a multiple of the CPU's own float32 error (4e-5 of the largest entry
# at this size: sums of thousands of residuals a frame).
POSE_F32_GRAD_RATIO = 3
# The optimised trajectory's ATE RMSE against the perturbed input's.
POSE_ATE_RATIO = 0.35
# tum-fts: the smoothed trajectory on the card against the CPU port's. Its
# folder is phase 7's with a ground truth jittered by FTS_JITTER_M and
# FTS_JITTER_ROT (quaternion x, y, z before normalising), so the smoothing
# has real gradients; it must move the trajectory by more than
# FTS_MIN_MOVE_TOLS x FTS_TOL (about 1e-3 at the CLI's lr of 1e-5).
FTS_EPOCHS, FTS_TOL, FTS_MIN_MOVE_TOLS = 100, 1e-4, 5
FTS_JITTER_M, FTS_JITTER_ROT = 0.01, 0.02
# tum-colmap-pose: phase 7's folder with a camera that moves COLMAP_STEP_M
# along x between frames; the recovered trajectory, and each of its steps,
# against the ground truth's, m.
COLMAP_STEP_M, COLMAP_POSE_TOL_M = 0.01, 1e-3


def quat_product(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    from hive_tpu_torch.core import transforms as T

    return T.quat_multiply(torch.as_tensor(q1), torch.as_tensor(q2)).numpy()


def quat_about(axis: np.ndarray, angles: np.ndarray) -> np.ndarray:
    """Scalar-last quaternions of rotations by ``angles`` (rad) about unit
    ``axis`` rows (or one axis)."""
    half = np.asarray(angles)[..., None] / 2
    return np.concatenate([np.sin(half) * axis, np.cos(half)], axis=-1)


def synthetic_features(gt: np.ndarray, K: np.ndarray, size, landmarks: np.ndarray, pairs,
                       rng, per_pair=None, noise_px: float = 0.0):
    """The port's FeatureSet of the landmarks both frames of each pair see
    (at most ``per_pair`` of them, drawn from ``rng``), projected with the
    world-to-camera poses ``gt``, pixel noise from ``rng``."""
    from hive_tpu_torch import pose_optimisation as P
    from hive_tpu_torch.geometric import pose_vec2mat

    width, height = size
    mats = np.stack([pose_vec2mat(p) for p in gt])
    cam = np.einsum("fij,lj->fli", mats[:, :3, :3], landmarks) + mats[:, None, :3, 3]
    depth = cam[..., 2]
    uv = cam[..., :2] / depth[..., None] * K[[0, 1], [0, 1]] + K[:2, 2]
    visible = ((depth > 0.1) & (uv[..., 0] >= 0) & (uv[..., 0] < width)
               & (uv[..., 1] >= 0) & (uv[..., 1] < height))
    sides = {"i": ([], [], []), "j": ([], [], [])}
    for i, j in pairs:
        both = np.flatnonzero(visible[i] & visible[j])
        if per_pair is not None and len(both) > per_pair:
            both = rng.choice(both, per_pair, replace=False)
        for side, frame in (("i", i), ("j", j)):
            index, points, depths = sides[side]
            index.append(np.full(len(both), frame, np.int64))
            points.append(uv[frame, both] + rng.normal(0, noise_px, (len(both), 2))
                          if noise_px else uv[frame, both])
            depths.append(depth[frame, both])
    data = {side: P.FeatureData(np.concatenate(index), np.concatenate(points).astype(np.float32),
                                np.concatenate(depths).astype(np.float32))
            for side, (index, points, depths) in sides.items()}
    return P.FeatureSet(np.asarray(K, np.float64), data["i"], data["j"])


def small_pose_problem(seed: int, scale: float):
    """tests/test_pose_optimisation.py's 8-frame problem: 120 landmarks,
    exact correspondences of the hierarchical pairs, positions perturbed."""
    from hive_tpu_torch import pose_optimisation as P

    K = np.array([[100.0, 0, 64.0], [0, 100.0, 48.0], [0, 0, 1.0]])
    angles = np.radians(np.linspace(0, 8, 8))
    gt = np.hstack([quat_about(np.array([0.0, 1.0, 0.0]), angles),
                    np.stack([np.linspace(0, 0.5, 8), np.zeros(8), np.zeros(8)], -1)])
    landmarks = np.random.default_rng(0).uniform([-1.5, -1.0, 2.0], [1.5, 1.0, 4.0], (120, 3))
    pairs = P.sample_frame_pairs(P.FrameSamplingMode.Hierarchical, 8)
    features = synthetic_features(gt, K, (128, 96), landmarks, pairs, np.random.default_rng(0))
    perturbed = gt.copy()
    perturbed[1:, 4:] += np.random.default_rng(seed).normal(scale=scale, size=(7, 3))
    return gt, features, perturbed


class PoseDataset:
    """What PoseOptimiser reads of a dataset, for a synthetic problem."""

    def __init__(self, trajectory, K, size, fps=30.0):
        from hive_tpu_torch.geometric import Trajectory

        self.camera_matrix = K
        self.camera_trajectory = Trajectory(trajectory)
        self.num_frames = len(trajectory)
        self.frame_width, self.frame_height = size
        self.fps = fps
        self.base_path = None


def ate_rmse(gt, estimate) -> float:
    from hive_tpu_torch.geometric import Trajectory

    err = Trajectory(gt).calculate_ate(Trajectory(estimate))
    return float(np.sqrt(np.mean(np.sum(err ** 2, axis=-1))))


def packed_on(features, device, dtype=torch.float32):
    from hive_tpu_torch import pose_optimisation as P

    packed = P.PoseOptimiser._pack_features(features, device=device)
    K = features.camera_matrix
    return ({k: v.to(dtype) if v.is_floating_point() else v for k, v in packed.items()},
            torch.tensor([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], dtype=dtype, device=device))


def chunk_loss_fn(frame_size):
    """The CPU test's chunk configuration: World3D, rigid, smoothing."""
    from hive_tpu_torch import pose_optimisation as P

    return P._make_loss_fn(P.ResidualType.World3D, P.AlignmentType.Rigid, True, False,
                           0.5, 1.0, 0.5, frame_size)


def pose_chunk(device, features, start: dict, frame_size=(128, 96), dtype=torch.float32):
    """One 25-epoch chunk of the CPU test's configuration (lr 1e-2, the
    1/30 m clip): (params, losses) on the host."""
    from hive_tpu_torch import pose_optimisation as P

    feats, intrinsics = packed_on(features, device, dtype)
    params = {k: torch.as_tensor(v, device=device).to(dtype) for k, v in start.items()}
    out, _, losses = P._run_epoch_chunk(
        params, P.adam_init(params), feats, intrinsics,
        torch.tensor(1e-2, dtype=dtype, device=device),
        torch.tensor(1 / 30, dtype=dtype, device=device),
        loss_fn=chunk_loss_fn(frame_size), num_epochs=25, position_only=False, use_clip=True)
    return {k: v.cpu().numpy() for k, v in out.items()}, losses.cpu().numpy()


def compare_chunks(name: str, start: dict, card, cpu) -> tuple:
    """The card's chunk against the CPU's: losses within POSE_LOSS_RTOL,
    parameters within POSE_CHUNK_TOL, frame 0 unmoved."""
    (card, card_losses), (cpu, cpu_losses) = card, cpu
    loss_err = float(np.max(np.abs(card_losses - cpu_losses) / np.abs(cpu_losses)))
    param_err = max(float(np.abs(card[k] - cpu[k]).max()) for k in ("q", "t"))
    if loss_err > POSE_LOSS_RTOL or param_err > POSE_CHUNK_TOL:
        raise AssertionError(f"{name}: losses {loss_err:.3e} (rtol {POSE_LOSS_RTOL}), "
                             f"params {param_err:.3e} (tol {POSE_CHUNK_TOL}) from the CPU's")
    if not np.array_equal(card["t"][0], start["t"][0]):
        raise AssertionError(f"{name}: frame 0 moved on the card")
    return loss_err, param_err


def pose_float64_run(device, features, start: dict):
    """Two steps and the fine-tune through optimise_packed_features in
    float64 (World3D, Image2D, World3D without smoothing; 200 epochs a loop
    at most): (trajectory, epochs a loop)."""
    from hive_tpu_torch import pose_optimisation as P

    feats, intrinsics = packed_on(features, device, torch.float64)
    params = {k: np.asarray(v, np.float64) for k, v in start.items()}
    epochs = []
    real = P._run_epoch_chunk

    def counting(*args, **kwargs):
        epochs.append(kwargs["num_epochs"])
        return real(*args, **kwargs)

    with mock.patch.object(P, "_run_epoch_chunk", counting):
        for residual, smooth in (("World3D", True), ("Image2D", True), ("World3D", False)):
            options = P.OptimisationOptions(num_epochs=200, learning_rate=5e-3,
                                            clip_distance=None, lr_scheduler_patience=10,
                                            early_stopping_patience=15)
            params = P.optimise_packed_features(
                feats, intrinsics, params, options, residual_type=P.ResidualType[residual],
                frame_size=(128, 96), fps=30.0, smooth_trajectory=smooth)
    values = np.hstack([params["q"].cpu().numpy(), params["t"].cpu().numpy()])
    return values, epochs


def check_pose_small(device) -> dict:
    """The 8-frame problem on the card against the CPU port: the first
    chunk within the CPU test's chunk tolerance (frame 0 bit-equal), a
    float64 run of two steps and the fine-tune within POSE_RUN_TOL with the
    same epochs, its ATE under POSE_ATE_RATIO of the perturbed input's."""
    gt, features, perturbed = small_pose_problem(seed=1, scale=0.05)
    start = {"q": perturbed[:, :4].astype(np.float32), "t": perturbed[:, 4:].astype(np.float32),
             "scale": np.zeros(0, np.float32), "shift": np.zeros(0, np.float32)}
    loss_err, param_err = compare_chunks("pose chunk", start, *(
        pose_chunk(d, features, start) for d in (device, "cpu")))

    gt, features, perturbed = small_pose_problem(seed=4, scale=0.04)
    start.update(q=perturbed[:, :4], t=perturbed[:, 4:])
    (card_run, card_epochs), (cpu_run, cpu_epochs) = (pose_float64_run(d, features, start)
                                                      for d in (device, "cpu"))
    run_err = float(np.abs(card_run - cpu_run).max())
    ate, before = ate_rmse(gt, card_run), ate_rmse(gt, perturbed)
    if card_epochs != cpu_epochs or run_err > POSE_RUN_TOL or ate > POSE_ATE_RATIO * before:
        raise AssertionError(f"pose float64 run: epochs {card_epochs} vs {cpu_epochs}, "
                             f"{run_err:.3e} from the CPU's (tol {POSE_RUN_TOL}), ATE {ate:.4f} "
                             f"against {before:.4f} perturbed")
    log(f"[pose] 8-frame problem: first chunk on the card vs the CPU losses {loss_err:.3e} "
        f"(rtol {POSE_LOSS_RTOL}), params {param_err:.3e} (tol {POSE_CHUNK_TOL}), frame 0 "
        f"pinned; float64 two steps + fine-tune {sum(card_epochs)} epochs "
        f"({len(card_epochs)} chunks) as on the CPU, {run_err:.3e} from it (tol "
        f"{POSE_RUN_TOL}), ATE RMSE {ate:.6f} m against {before:.6f} perturbed")
    return dict(chunk_loss_rel_err=loss_err, chunk_param_err=param_err, f64_run_err=run_err,
                f64_epochs=sum(card_epochs), f64_ate_m=ate, f64_perturbed_ate_m=before)


def pose_user_problem(seed: int = SEED):
    """pose-optimise's inputs: the ground truth, the feature set and the
    perturbed trajectory."""
    from hive_tpu_torch import pose_optimisation as P
    from hive_tpu_torch.geometric import pose_vec2mat

    rng = np.random.default_rng(seed)
    s = np.linspace(0.0, 1.0, POSE_FRAMES)
    yaw = np.radians(15.0) * np.sin(2 * np.pi * s)
    pitch = np.radians(5.0) * np.sin(4 * np.pi * s + 0.3)
    q = quat_product(quat_about(np.array([0.0, 1.0, 0.0]), yaw),
                     quat_about(np.array([1.0, 0.0, 0.0]), pitch))
    centres = np.stack([1.5 * s, 0.1 * np.sin(6 * np.pi * s), 0.2 * np.sin(2 * np.pi * s)], -1)
    t = np.stack([-pose_vec2mat(np.r_[qi, 0, 0, 0])[:3, :3] @ c for qi, c in zip(q, centres)])
    gt = np.hstack([q, t])
    K = np.array([[POSE_FOCAL, 0, (POSE_W - 1) / 2], [0, POSE_FOCAL, (POSE_H - 1) / 2],
                  [0, 0, 1.0]])
    landmarks = rng.uniform([-2.5, -1.6, 2.5], [4.0, 1.6, 5.0], (POSE_LANDMARKS, 3))
    pairs = P.sample_frame_pairs(P.FrameSamplingMode.Hierarchical, POSE_FRAMES)
    features = synthetic_features(gt, K, (POSE_W, POSE_H), landmarks, pairs, rng,
                                  per_pair=POSE_PER_PAIR, noise_px=POSE_NOISE_PX)
    # A drift, as odometry's: smooth (under the 1 m/s distance clip), zero at
    # frame 0 (the pinned frame), POSE_PERTURB_M and POSE_PERTURB_DEG at its
    # largest on each axis.
    drift = np.stack([np.sin(np.pi * s * f + p) - np.sin(p) for f, p in
                      zip(rng.uniform(0.5, 2.0, 6), rng.uniform(0, 2 * np.pi, 6))], -1)
    drift /= np.abs(drift).max(axis=0)
    perturbed = gt.copy()
    perturbed[:, 4:] += POSE_PERTURB_M * drift[:, :3]
    angles = np.radians(POSE_PERTURB_DEG) * drift[:, 3:]
    for axis in range(3):
        perturbed[:, :4] = quat_product(quat_about(np.eye(3)[axis], angles[:, axis]),
                                        perturbed[:, :4])
    return gt, K, features, pairs, perturbed


def check_pose_user_chunk(device, features, perturbed) -> dict:
    """pose-optimise's correspondences through the CPU test's chunk
    configuration, on the card and on the CPU. Its first 25-epoch chunk in
    float64, within POSE_LOSS_RTOL and POSE_CHUNK_TOL (in float32 the
    chunk is not reproducible at this size: Adam turns the rounding noise
    of the quaternions' radial gradients into steps of about lr, and the
    CPU's own float32 chunk lands 4e-3 from its float64 one). Then, in
    float32 at the perturbed start, the loss within POSE_LOSS_RTOL of the
    CPU's float64 loss and each gradient no further from the CPU's float64
    gradient than POSE_F32_GRAD_RATIO x the CPU's float32 gradient is (of
    the largest entry), which holds the card's float32 scatter of 178k rows
    in the backward."""
    from hive_tpu_torch import pose_optimisation as P

    start = {"q": perturbed[:, :4], "t": perturbed[:, 4:], "scale": np.zeros(0),
             "shift": np.zeros(0)}
    loss_err, param_err = compare_chunks("pose-optimise f64 chunk", start, *(
        pose_chunk(d, features, start, (POSE_W, POSE_H), torch.float64)
        for d in (device, "cpu")))

    loss_fn = chunk_loss_fn((POSE_W, POSE_H))

    def loss_and_grads(where, dtype):
        feats, intrinsics = packed_on(features, where, dtype)
        params = {k: torch.as_tensor(v, device=where).to(dtype) for k, v in start.items()}
        loss, grads = P._loss_and_grads(loss_fn, params, feats, intrinsics)
        return float(loss), {k: grads[k].double().cpu().numpy() for k in ("q", "t")}

    (ref_loss, ref), (card_loss, card), (_, cpu) = (
        loss_and_grads(where, dtype) for where, dtype in
        (("cpu", torch.float64), (device, torch.float32), ("cpu", torch.float32)))
    f32_loss_err = abs(card_loss - ref_loss) / abs(ref_loss)
    grad_err = {k: float(np.abs(card[k] - ref[k]).max() / np.abs(ref[k]).max()) for k in ref}
    cpu_grad_err = {k: float(np.abs(cpu[k] - ref[k]).max() / np.abs(ref[k]).max()) for k in ref}
    if f32_loss_err > POSE_LOSS_RTOL or any(
            grad_err[k] > POSE_F32_GRAD_RATIO * cpu_grad_err[k] for k in ref):
        raise AssertionError(f"pose-optimise float32: loss {f32_loss_err:.3e} from the CPU's "
                             f"float64 (rtol {POSE_LOSS_RTOL}), gradients {grad_err} against "
                             f"the CPU's float32 {cpu_grad_err} (ratio {POSE_F32_GRAD_RATIO})")
    log(f"[pose] pose-optimise first chunk in float64, card vs CPU: losses {loss_err:.3e} "
        f"(rtol {POSE_LOSS_RTOL}), params {param_err:.3e} (tol {POSE_CHUNK_TOL}), frame 0 "
        f"pinned; float32 loss {f32_loss_err:.3e} from the CPU's float64, gradients "
        f"{grad_err} of the largest entry (the CPU's float32 {cpu_grad_err})")
    return dict(f64_chunk_loss_rel_err=loss_err, f64_chunk_param_err=param_err,
                f32_loss_rel_err=f32_loss_err, f32_grad_err=grad_err,
                cpu_f32_grad_err=cpu_grad_err)


def run_pose_optimise(device) -> dict:
    """pose-optimise: PoseOptimiser's steps at the user's size with
    OptimisationOptions() (PairWise3D, Global3D, the fine-tune; 4,000 epochs
    a loop at most, 25 a chunk). Per loop: epochs, wall s, peak device
    memory; then one 25-epoch chunk of the loop's configuration on its
    result, profiled (device ms and kernels a epoch) and as a launch loop
    (CUDA events). The trajectory must be finite; its ATE RMSE is logged
    beside the perturbed input's."""
    from hive_tpu_torch import pose_optimisation as P

    start = time.perf_counter()
    gt, K, features, pairs, perturbed = pose_user_problem()
    setup_s = time.perf_counter() - start
    parity = check_pose_user_chunk(device, features, perturbed)
    loops = []

    class MeasuredPoseOptimiser(P.PoseOptimiser):
        def _optimisation_loop(self, feature_set, params, options, residual_type,
                               smooth_trajectory=True):
            epochs = []
            real = P._run_epoch_chunk

            def counting(*args, **kwargs):
                epochs.append(kwargs["num_epochs"])
                return real(*args, **kwargs)

            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            begin = time.perf_counter()
            with mock.patch.object(P, "_run_epoch_chunk", counting):
                out = super()._optimisation_loop(feature_set, params, options, residual_type,
                                                 smooth_trajectory)
            torch.cuda.synchronize()
            wall = time.perf_counter() - begin
            peak = torch.cuda.max_memory_allocated()

            feats, intrinsics = packed_on(feature_set, self.device)
            loss_fn = P._make_loss_fn(residual_type, options.alignment_type, smooth_trajectory,
                                      options.position_only, options.pose_t_reg,
                                      options.pose_r_reg, options.l2_regularisation,
                                      (POSE_W, POSE_H))
            lr = torch.tensor(options.learning_rate, device=self.device)
            clip = torch.tensor((options.clip_distance or 0.0) / self.dataset.fps,
                                dtype=torch.float32, device=self.device)

            def chunk():
                return P._run_epoch_chunk(out, P.adam_init(out), feats, intrinsics, lr, clip,
                                          loss_fn=loss_fn, num_epochs=25,
                                          position_only=options.position_only,
                                          use_clip=options.clip_distance is not None)

            device_ms, kernels = device_profile(chunk, reps=2, warmup=1)
            loop_ms = events_ms(chunk, reps=2, warmup=0)
            loops.append(dict(correspondences=len(feature_set), epochs=sum(epochs),
                              wall_s=wall, peak_bytes=int(peak),
                              device_ms_per_epoch=device_ms / 25, kernels_per_epoch=kernels / 25,
                              loop_ms_per_epoch=loop_ms / 25))
            return out

    optimiser = MeasuredPoseOptimiser(PoseDataset(perturbed, K, (POSE_W, POSE_H)), debug=False,
                                      optimisation_options=P.OptimisationOptions(),
                                      device=device)
    torch.cuda.synchronize()
    start = time.perf_counter()
    params = optimiser._optimise_pose(features, optimiser._init_params(perturbed), POSE_FRAMES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    result = optimiser._params_to_trajectory(params).values
    ate, before = ate_rmse(gt, result), ate_rmse(gt, perturbed)
    if not np.isfinite(result).all() or len(loops) != 4:
        raise AssertionError(f"pose-optimise: {len(loops)} loops, finite "
                             f"{np.isfinite(result).all()}")
    names = ["PairWise3D pass 1", "PairWise3D pass 2", "Global3D", "fine-tune"]
    for name, loop in zip(names, loops):
        loop["step"] = name
        log(f"[pose] {name}: {loop['correspondences']} correspondences, {loop['epochs']} "
            f"epochs in {loop['wall_s']:.3f} s; a 25-epoch chunk: "
            f"{loop['device_ms_per_epoch']:.6f} ms device and "
            f"{loop['kernels_per_epoch']:.1f} kernels an epoch, "
            f"{loop['loop_ms_per_epoch']:.6f} ms launch loop an epoch; peak device memory "
            f"{loop['peak_bytes']} B")
    log(f"[pose] pose-optimise: {POSE_FRAMES} frames, {len(pairs)} pairs, {len(features)} "
        f"correspondences (made in {setup_s:.1f} s), {len(loops)} loops, "
        f"{sum(loop['epochs'] for loop in loops)} epochs in {wall:.3f} s; ATE RMSE "
        f"{ate:.6f} m from {before:.6f} m perturbed")
    return dict(frames=POSE_FRAMES, pairs=len(pairs), correspondences=len(features),
                wall_s=wall, ate_m=ate, perturbed_ate_m=before, loops=loops, parity=parity)


def run_fts_conversion(device, launches, gt_profiling, tmp: str) -> dict:
    """tum-fts: a user's run with ``--fts_num_epochs FTS_EPOCHS`` on phase
    7's TUM folder with a jittered ground truth, nothing patched. Checks the
    launch counts, both meshes, the stages run one after the other; then
    the foreground optimiser on the converted dataset on the card (timed)
    against the CPU port's within FTS_TOL, and moving the trajectory by
    more than FTS_MIN_MOVE_TOLS x FTS_TOL."""
    from hive_tpu_torch.io import HiveDataset
    from hive_tpu_torch.pose_optimisation import ForegroundPoseOptimiser

    tum, out = os.path.join(tmp, "tum_jittered"), os.path.join(tmp, "smoothed")
    rng = np.random.default_rng(SEED)
    q = np.hstack([FTS_JITTER_ROT * rng.normal(size=(TUM_FRAMES, 3)), np.ones((TUM_FRAMES, 1))])
    copy_tum_with_poses(os.path.join(tmp, "tum"), tum, np.hstack([
        q / np.linalg.norm(q, axis=1, keepdims=True),
        FTS_JITTER_M * rng.normal(size=(TUM_FRAMES, 3))]))
    argv = ["hive_tpu_torch", "--dataset_path", tum, "--output_path", out, "--fts_num_epochs",
            str(FTS_EPOCHS), "--key_frame_threshold", "1.0", "--webxr_path",
            os.path.join(tmp, "webxr_fts"), "--log_file", os.path.join(tmp, "pipeline_fts.log")]
    reset_launch_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    with mock.patch.object(sys, "argv", argv):
        runpy.run_module("hive_tpu_torch", run_name="__main__", alter_sys=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches["fts"] = main_launch_counts()
    check_launches("the --fts_num_epochs run", launches["fts"], TUM_FRAMES)
    with open(os.path.join(out, "profiling.json")) as f:
        profiling = json.load(f)
    if profiling["timing"]["stages_overlapped"] is not False:
        raise AssertionError("the --fts_num_epochs run overlapped its stages")
    check_meshes_finite(out)

    dataset = HiveDataset(out)
    torch.cuda.synchronize()
    start = time.perf_counter()
    card = ForegroundPoseOptimiser(dataset, num_epochs=FTS_EPOCHS, device=device).run().values
    torch.cuda.synchronize()
    optimiser_s = time.perf_counter() - start
    cpu = ForegroundPoseOptimiser(dataset, num_epochs=FTS_EPOCHS, device="cpu").run().values
    err = float(np.abs(card - cpu).max())
    if err > FTS_TOL:
        raise AssertionError(f"smoothed trajectory {err:.3e} from the CPU port's "
                             f"(tol {FTS_TOL})")
    moved = float(np.abs(card - dataset.camera_trajectory.values).max())
    if moved <= FTS_MIN_MOVE_TOLS * FTS_TOL:
        raise AssertionError(f"the smoothing moved the trajectory by {moved:.3e}, not more "
                             f"than {FTS_MIN_MOVE_TOLS} x {FTS_TOL}")
    fg = profiling["timing"]["foreground_reconstruction"]["total"]
    log(f"[fts] {TUM_FRAMES} frames meshed with --fts_num_epochs {FTS_EPOCHS} in {wall:.1f} s, "
        f"{profiling['elapsed_time']['per_frame']:.4f} s/frame; stages_overlapped false; "
        f"launches {launches['fts']}; foreground_reconstruction {fg:.4f} s (phase 7's "
        f"{gt_profiling['timing']['foreground_reconstruction']['total']:.4f}); the optimiser "
        f"alone on the card {optimiser_s:.3f} s; smoothed trajectory {err:.3e} from the CPU "
        f"port's (tol {FTS_TOL}), {moved:.3e} from the input")
    return dict(wall_s=wall, per_frame_s=profiling["elapsed_time"]["per_frame"],
                foreground_reconstruction_s=fg, optimiser_s=optimiser_s, cpu_err=err,
                moved=moved)


def check_meshes_finite(out: str) -> None:
    from hive_tpu_torch.meshing.gltf import load_glb

    foreground = load_glb(os.path.join(out, "mesh", "fg.glb"))
    background = next(iter(load_glb(os.path.join(out, "mesh", "bg.glb")).geometry.values()))
    for name in foreground.node_names:
        if not np.isfinite(foreground.geometry[name].vertices).all():
            raise AssertionError(f"{out} fg.glb frame {name}: non-finite vertices")
    if len(background.vertices) == 0 or not np.isfinite(background.vertices).all():
        raise AssertionError(f"{out} bg.glb holds no (finite) vertices")


def run_colmap_pose_conversion(device, launches, gt_profiling, tmp: str) -> dict:
    """tum-colmap-pose: a user's run with ``--estimate_pose`` on phase 7's
    TUM folder, its camera moving COLMAP_STEP_M along x between frames, and
    ``--binary_path`` a stand-in ``colmap`` this phase writes (a sparse
    model of the staged frames from the TUM ground truth, in units of
    COLMAP_SCALE metres, its points on the wall), nothing else patched.
    Checks the launch counts, both meshes, the trajectory back at metric
    scale: each pose and each step between frames within COLMAP_POSE_TOL_M
    of the ground truth's (a missing scale would leave COLMAP_SCALE x
    COLMAP_STEP_M steps); and recomputes the scale the adaptor recovered."""
    from hive_tpu_torch.dataset_adaptors import TUMAdaptor
    from hive_tpu_torch.geometric import Trajectory
    from hive_tpu_torch.io import (COLMAPProcessor, HiveDataset, ImageFolderDataset,
                                   make_depth_map_transform)

    tum, out = os.path.join(tmp, "tum_moving"), os.path.join(tmp, "posed")
    copy_tum_with_poses(os.path.join(tmp, "tum"), tum, np.array(
        [[0, 0, 0, 1, COLMAP_STEP_M * i, 0, 0] for i in range(TUM_FRAMES)], dtype=np.float64))
    truth = TUMAdaptor(tum, os.path.join(tmp, "unused")).camera_trajectory.values[:TUM_FRAMES]
    frame_step = 15  # the CLI's default
    stand_in = write_colmap_stand_in(os.path.join(tmp, "colmap_bin"), truth,
                                     TUMAdaptor.intrinsic_matrix, (TUM_W, TUM_H), depth=2.0,
                                     frame_step=frame_step)
    argv = ["hive_tpu_torch", "--dataset_path", tum, "--output_path", out, "--estimate_pose",
            "--binary_path", stand_in, "--key_frame_threshold", "1.0", "--webxr_path",
            os.path.join(tmp, "webxr_pose"), "--log_file", os.path.join(tmp, "pipeline_pose.log")]
    reset_launch_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    with mock.patch.object(sys, "argv", argv):
        runpy.run_module("hive_tpu_torch", run_name="__main__", alter_sys=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches["colmap_pose"] = main_launch_counts()
    check_launches("the --estimate_pose run", launches["colmap_pose"], TUM_FRAMES)
    check_meshes_finite(out)
    with open(os.path.join(out, "profiling.json")) as f:
        profiling = json.load(f)

    dataset = HiveDataset(out)
    if not dataset.metadata.estimate_pose:
        raise AssertionError("metadata.json does not say estimate_pose")
    want = Trajectory(truth).normalise().values
    got = dataset.camera_trajectory.values
    err = float(np.abs(got - want).max())
    steps = np.linalg.norm(np.diff(got[:, 4:], axis=0), axis=1)
    step_err = float(np.abs(steps - np.linalg.norm(np.diff(want[:, 4:], axis=0), axis=1)).max())
    workspace = os.path.join(out, "debug", "colmap", "workspace")
    processor = COLMAPProcessor(os.path.join(out, "debug", "colmap", "rgb"), workspace)
    K, poses = processor.load_camera_params()
    sparse = processor.get_sparse_depth_maps(K, poses)
    depth = ImageFolderDataset(dataset.path_to_depth_maps, transform=make_depth_map_transform(
        HiveDataset.depth_scaling_factor, dataset.metadata.max_depth))
    subset = TUMAdaptor._get_frame_subset(TUM_FRAMES, frame_step)[1]
    est = np.stack([depth[i] for i in subset])
    both = (sparse > 0) & (est > 0)
    scale = float(np.median(est[both] / sparse[both]))
    if err > COLMAP_POSE_TOL_M or step_err > COLMAP_POSE_TOL_M \
            or abs(scale * COLMAP_SCALE - 1) > 0.01 \
            or not np.allclose(np.loadtxt(os.path.join(out, "camera_matrix.txt")), K):
        raise AssertionError(f"--estimate_pose: trajectory {err:.3e} m from the ground truth, "
                             f"its steps {step_err:.3e} m from the truth's (tol "
                             f"{COLMAP_POSE_TOL_M}), scale {scale:.6f} (want "
                             f"{1 / COLMAP_SCALE:.6f})")
    stage = profiling["timing"]["load_dataset"]["get_camera_parameters"]
    log(f"[colmap] {TUM_FRAMES} frames converted with --estimate_pose (stand-in colmap, "
        f"frames {subset} staged) and meshed in {wall:.1f} s, "
        f"{profiling['elapsed_time']['per_frame']:.4f} s/frame; get_camera_parameters "
        f"{stage:.4f} s (phase 7's "
        f"{gt_profiling['timing']['load_dataset']['get_camera_parameters']:.4f}); metric "
        f"scale {scale:.6f} ({int(both.sum())} sparse depths; 1 / {COLMAP_SCALE} = "
        f"{1 / COLMAP_SCALE:.6f}); trajectory {err:.3e} m from the ground truth, steps of "
        f"{steps.min():.6f}-{steps.max():.6f} m ({step_err:.3e} from the truth's "
        f"{COLMAP_STEP_M} m); launches {launches['colmap_pose']}")
    return dict(wall_s=wall, per_frame_s=profiling["elapsed_time"]["per_frame"],
                get_camera_parameters_s=stage, scale=scale, trajectory_err_m=err,
                step_err_m=step_err)


# ---------------------------------------------------------------------------
# The feature and pose layer (SIFT, k-NN, homography, PnP): no kernel of its
# own, plain PyTorch on the card.
# ---------------------------------------------------------------------------

FEATURE_W, FEATURE_H, FEATURE_NFEATURES = 640, 480, 2048
# The CPU tests' tolerances, which hold the port to OpenCV
# (tests/test_torch_sift.py, tests/test_torch_sfm.py import them), here for
# the card against the port's CPU run: keypoints within 0.5 px, descriptors
# of the same keypoints within an L2 distance, inlier sets within a share
# of their size, the PnP pose within a rotation and a translation.
KP_SHARE = 0.99
DESC_L2, DESC_SHARE = 2.0, 0.98
H_SYMDIFF = 0.02
PNP_SYMDIFF, PNP_ROT_DEG, PNP_T_M = 0.02, 1e-4, 1e-6
# tum-pnp-pose: twice the ATE of hive_tpu's own native path on the same
# 30-frame VGA folder at the CLI's frame step (1.07 mm, run on the CPU with
# OpenCV 5.0.0).
PNP_TUM_FRAMES = 30
PNP_ATE_M = 2.2e-3


def keypoint_agreement(card, cpu) -> dict:
    """The share of each side's keypoints within 0.5 px of the other's, and
    the descriptor distances of the keypoints that both found (position
    within 0.01 px, angle within 0.01 degrees)."""
    a, b = card.xy.cpu().double(), cpu.xy.double()
    dist = torch.cdist(a, b)
    share = min(float((dist.min(dim=1).values < 0.5).double().mean()),
                float((dist.min(dim=0).values < 0.5).double().mean()))
    turn = (card.angle.cpu()[:, None] - cpu.angle[None]).abs()
    same = (dist < 0.01) & (torch.minimum(turn, 360 - turn) < 0.01)
    rows = torch.nonzero(same.any(dim=1))[:, 0]
    cols = same[rows].double().argmax(dim=1)
    l2 = (card.descriptors.cpu()[rows] - cpu.descriptors[cols]).norm(dim=1)
    return dict(share=share, paired=int(len(rows)),
                desc_share=float((l2 <= DESC_L2).double().mean()) if len(rows) else 0.0,
                desc_max=float(l2.max()) if len(rows) else 0.0)


def stage_times(fn) -> dict:
    """Device ms and device operations of one call (torch.profiler), and
    the launch loop's ms (CUDA events, host cost included)."""
    ms, ops = device_profile(fn, reps=3, warmup=1)
    return dict(ms=ms, kernels=ops, loop_ms=events_ms(fn, reps=3, warmup=1))


def check_features(device) -> dict:
    """[sift]: the feature layer at full width on the card, on two VGA
    frames of the textured wall (the camera 1 cm and 0.15 degrees apart):
    SIFT with 2048 features, the exact k-NN, the homography filter of the
    feature extractor and the odometry's RANSAC PnP, each held to the port's
    CPU run on the same inputs (TF32 off) and timed."""
    from hive_tpu_torch.ops import homography, matching, pnp, sift

    phase_start = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on: the card would not compute the CPU's float32")
    texture, K = wall_texture(), wall_camera()
    frames = [render_wall(texture, pose, K, FEATURE_W, FEATURE_H)
              for pose in wall_trajectory(2)]
    greys = [sift.rgb_to_grey(torch.from_numpy(rgb)) for rgb, _ in frames]
    depth = torch.from_numpy(frames[0][1].astype(np.float32))

    torch.cuda.reset_peak_memory_stats()
    card = [sift.detect_and_compute(g.to(device), nfeatures=FEATURE_NFEATURES) for g in greys]
    torch.cuda.synchronize()
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    cpu = [sift.detect_and_compute(g, nfeatures=FEATURE_NFEATURES) for g in greys]
    agreement = [keypoint_agreement(c, h) for c, h in zip(card, cpu)]
    for frame, got in enumerate(agreement):
        if got["share"] < KP_SHARE or got["desc_share"] < DESC_SHARE:
            raise AssertionError(f"SIFT on the card vs the CPU, frame {frame}: {got} (want "
                                 f"keypoints {KP_SHARE}, descriptors {DESC_SHARE} within "
                                 f"{DESC_L2})")

    # The k-NN of the CPU's descriptors on the card: exact, so equal.
    desc = [c.descriptors.to(device) for c in cpu]
    indices, distances = matching.knn2(*desc)
    cpu_indices, cpu_distances = matching.knn2(cpu[0].descriptors, cpu[1].descriptors)
    if not (torch.equal(indices.cpu(), cpu_indices)
            and torch.equal(distances.cpu(), cpu_distances)):
        raise AssertionError("the k-NN on the card differs from the CPU's")

    # The extractor's pair (ratio 0.7) through the homography filter, and
    # the odometry's (ratio 0.75) lifted with frame 0's depth through PnP.
    def generator(where):
        g = torch.Generator(device=where)
        g.manual_seed(SEED)
        return g

    pairs = matching.match_descriptors(cpu[0].descriptors, cpu[1].descriptors, 0.7, strict=False)
    pts = (cpu[0].xy[pairs[:, 0]], cpu[1].xy[pairs[:, 1]])
    _, mask = homography.find_homography(*(p.to(device) for p in pts), generator=generator(device))
    _, cpu_mask = homography.find_homography(*pts, generator=generator("cpu"))
    h_diff = int((mask.cpu() ^ cpu_mask).sum())
    if h_diff > H_SYMDIFF * int(cpu_mask.sum()):
        raise AssertionError(f"homography inliers: {h_diff} differ of {int(cpu_mask.sum())}")

    odometry = matching.match_descriptors(cpu[0].descriptors, cpu[1].descriptors, 0.75)
    uv = cpu[0].xy[odometry[:, 0]].double()
    z = depth[torch.round(uv[:, 1]).long(), torch.round(uv[:, 0]).long()].double()
    K64 = torch.from_numpy(K)
    objects = torch.stack([(uv[:, 0] - K64[0, 2]) * z / K64[0, 0],
                           (uv[:, 1] - K64[1, 2]) * z / K64[1, 1], z], dim=1)
    pixels = cpu[1].xy[odometry[:, 1]].double()

    def solve(where):
        o, x, k = objects.to(where), pixels.to(where), K64.to(where)
        ok, r, t, inliers = pnp.solve_pnp_ransac(o, x, k, generator=generator(where))
        r, t = pnp.refine_pose(o[inliers], x[inliers], k, r, t)
        return pnp.rodrigues_to_matrix(r).cpu(), t.cpu(), inliers

    (R, t, inliers), (cpu_R, cpu_t, cpu_inliers) = solve(device), solve("cpu")
    p_diff = len(set(inliers.cpu().tolist()) ^ set(cpu_inliers.tolist()))
    angle = float(np.degrees(np.arccos(np.clip((float(torch.trace(cpu_R.T @ R)) - 1) / 2,
                                               -1, 1))))
    t_err = float((t - cpu_t).abs().max())
    if p_diff > PNP_SYMDIFF * len(cpu_inliers) or angle > PNP_ROT_DEG or t_err > PNP_T_M:
        raise AssertionError(f"PnP on the card vs the CPU: {p_diff} inliers differ of "
                             f"{len(cpu_inliers)}, rotation {angle:.3e} deg, translation "
                             f"{t_err:.3e} m")

    grey0 = greys[0].to(device)
    points = tuple(p.to(device) for p in pts)
    o64, x64, k64 = objects.to(device), pixels.to(device), K64.to(device)
    times = {
        "sift": stage_times(lambda: sift.detect_and_compute(grey0, nfeatures=FEATURE_NFEATURES)),
        "knn": stage_times(lambda: matching.knn2(*desc)),
        "homography": stage_times(lambda: homography.find_homography(
            *points, generator=generator(device))),
        "pnp": stage_times(lambda: pnp.solve_pnp_ransac(o64, x64, k64,
                                                         generator=generator(device))),
    }
    smi = nvidia_smi_line()
    counts = dict(keypoints=[len(c) for c in card], matches=len(pairs),
                  homography_inliers=int(mask.sum()), pnp_matches=len(odometry),
                  pnp_inliers=len(inliers))
    log(f"[sift] {smi}: {FEATURE_W}x{FEATURE_H}, {FEATURE_NFEATURES} features: {counts}; "
        + "; ".join(f"{name} {v['ms']:.4f} ms device, {v['kernels']:.0f} kernels, launch loop "
                    f"{v['loop_ms']:.4f} ms" for name, v in times.items())
        + f"; peak device memory {peak_mb:.1f} MiB (SIFT on two frames)")
    log(f"[sift] card vs CPU: keypoints {[round(a['share'], 6) for a in agreement]} within "
        f"0.5 px, descriptors {[round(a['desc_share'], 6) for a in agreement]} within "
        f"{DESC_L2} (max {max(a['desc_max'] for a in agreement):.3f}); k-NN equal; homography "
        f"inliers {h_diff} differ; PnP inliers {p_diff} differ, rotation {angle:.3e} deg, "
        f"translation {t_err:.3e} m; the phase took {time.perf_counter() - phase_start:.1f} s")
    return dict(counts=counts, times=times, peak_mib=peak_mb, agreement=agreement,
                homography_diff=h_diff, pnp_diff=p_diff, pnp_rotation_deg=angle,
                pnp_translation_m=t_err)


class LogTimes(logging.Handler):
    """The time of each INFO record whose message starts with a given
    prefix, and the messages themselves."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append((record.created, record.getMessage()))

    def first(self, prefix: str):
        return next(((t, m) for t, m in self.records if m.startswith(prefix)), (None, None))


def run_pnp_pose_conversion(device, launches, gt_profiling, colmap_run, tmp: str) -> dict:
    """tum-pnp-pose: a user's run with ``--estimate_pose`` and no COLMAP
    binary on a 30-frame VGA TUM folder of the textured wall, the camera
    sliding 1 cm a frame and turning 0.15 degrees, nothing patched: PnP
    odometry on the card at the CLI's frame step. Checks the launch counts,
    both meshes, the ATE against the ground truth (PNP_ATE_M); then
    ``python -m hive_tpu_torch.pose_optimisation`` on the converted folder
    with no cached feature set: its extraction time and the pairs kept."""
    from hive_tpu_torch.io import HiveDataset

    phase_start = time.perf_counter()
    tum, out = os.path.join(tmp, "tum_wall"), os.path.join(tmp, "pnp_posed")
    poses = wall_trajectory(PNP_TUM_FRAMES)
    write_wall_tum(tum, PNP_TUM_FRAMES, FEATURE_W, FEATURE_H, poses)
    argv = ["hive_tpu_torch", "--dataset_path", tum, "--output_path", out, "--estimate_pose",
            "--binary_path", os.path.join(tmp, "no_colmap"), "--key_frame_threshold", "1.0",
            "--webxr_path", os.path.join(tmp, "webxr_pnp"), "--log_file",
            os.path.join(tmp, "pipeline_pnp.log")]
    reset_launch_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    with mock.patch.object(sys, "argv", argv), recording_ordered_hist_shapes([]) as shapes:
        runpy.run_module("hive_tpu_torch", run_name="__main__", alter_sys=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches["pnp_pose"] = main_launch_counts()
    check_launches("the --estimate_pose run without COLMAP", launches["pnp_pose"],
                   PNP_TUM_FRAMES)
    check_meshes_finite(out)
    with open(os.path.join(out, "profiling.json")) as f:
        profiling = json.load(f)
    dataset = HiveDataset(out)
    if not dataset.metadata.estimate_pose:
        raise AssertionError("metadata.json does not say estimate_pose")
    ate = ate_m(poses, dataset.camera_trajectory.values)
    if not ate <= PNP_ATE_M:
        raise AssertionError(f"--estimate_pose without COLMAP: ATE {ate:.6f} m (bound "
                             f"{PNP_ATE_M} m)")
    stage = profiling["timing"]["load_dataset"]["get_camera_parameters"]
    log(f"[pnp] {PNP_TUM_FRAMES} frames converted with --estimate_pose and no COLMAP (PnP "
        f"odometry on the card) and meshed in {wall:.1f} s, "
        f"{profiling['elapsed_time']['per_frame']:.4f} s/frame; get_camera_parameters "
        f"{stage:.4f} s (phase 13's stand-in COLMAP {colmap_run['get_camera_parameters_s']:.4f} "
        f"s, phase 7's GT {gt_profiling['timing']['load_dataset']['get_camera_parameters']:.4f}"
        f" s); ATE {ate:.6f} m (bound {PNP_ATE_M}); launches {launches['pnp_pose']}; "
        f"ordered_hist calls (rows, entries, bins) {shapes}")

    # The pose optimiser's CLI on the converted folder, no cached features.
    debug = os.path.join(out, "pose_optim")
    if os.path.exists(os.path.join(debug, "feature_set.npz")):
        raise AssertionError("a feature set was cached before the run")
    handler, root = LogTimes(), logging.getLogger()
    level = root.level
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    start = time.perf_counter()
    try:
        with mock.patch.object(sys, "argv", ["hive_tpu_torch.pose_optimisation", out]):
            runpy.run_module("hive_tpu_torch.pose_optimisation", run_name="__main__",
                             alter_sys=True)
        torch.cuda.synchronize()
    finally:
        root.removeHandler(handler)
        root.setLevel(level)
    optimise_s = time.perf_counter() - start
    began, _ = handler.first("Detecting and matching image features")
    ended, kept = handler.first("Usable frame pairs")
    if began is None or ended is None or not os.path.isfile(os.path.join(debug,
                                                                           "feature_set.npz")):
        raise AssertionError("pose_optimisation did not extract features from the frames")
    with np.load(os.path.join(debug, "feature_set.npz")) as cached:
        correspondences = len(cached["index_i"])
    log(f"[pnp] python -m hive_tpu_torch.pose_optimisation with no cache: extraction "
        f"{ended - began:.3f} s ({kept}; {correspondences} correspondences), whole CLI "
        f"{optimise_s:.1f} s; the phase took {time.perf_counter() - phase_start:.1f} s")
    return dict(wall_s=wall, per_frame_s=profiling["elapsed_time"]["per_frame"],
                ordered_hist_shapes=shapes,
                get_camera_parameters_s=stage, ate_m=ate, extraction_s=ended - began,
                pairs_kept=kept, correspondences=correspondences, optimise_cli_s=optimise_s)


# ---------------------------------------------------------------------------
# [video]: video and Stray Scanner inputs.
# ---------------------------------------------------------------------------

# The decoder check's I_PCM fixtures: (name, frames, width, height, options).
VIDEO_FIXTURES = (("vga", 30, 640, 480, {}), ("vga_out_of_order", 30, 640, 480,
                                                dict(reorder=True)),
                  ("1080p", 10, 1920, 1080, {}))
# The phone clip (1080p at 30 fps) and the Stray Scanner capture (rgb.mp4 at
# 1920 x 1440, depth and confidence at 256 x 192), and their frames once the
# CLI has resized them to a long side of 640 (the capture's rotated first).
PHONE_W, PHONE_H, STRAY_W, STRAY_H, STRAY_DEPTH_HW = 1920, 1080, 1920, 1440, (192, 256)
VIDEO_FRAMES = 30
# The phone clip's JPEG quality (a phone's Motion JPEG runs at 85-95).
PHONE_JPEG_QUALITY = 90
# The MPEG-4 Part 2 phone clip: vop_quant and GOP length as cv2's mp4v
# writer codes these frames (vop_quant 3 after its first I-VOP, an I-VOP
# every 12 frames: tests/torch_mpeg4_cv2_writer.py); a video packet a row of
# macroblocks and 4MV on every other one, which cv2's files do not hold, to
# run those paths of the decoder; the frames whose card reads are held to
# the CPU's (the first I-VOP, the last P-VOP of its GOP, the next I-VOP, the
# last), and the least PSNR (dB) of their decoded luma against the renders
# (the same script read 47.12-47.38; AC prediction in the wrong direction
# reads 33.3 on the I-VOPs).
PHONE_MPEG4_QSCALE, PHONE_MPEG4_GOP, PHONE_MPEG4_RESYNC = 3, 12, 120
PHONE_MPEG4_CHECKED = (0, 11, 12, 29)
PHONE_MPEG4_MIN_PSNR = 45.0
# The H.264 phone clip (video.h264.write_h264_mp4, MotionPlanner): CAVLC,
# an IDR picture every 12 frames, up to four references, a slice a row,
# deblocking on, QP PHONE_H264_QP; the frames whose card reads are held to
# the CPU's (the first IDR picture, the last P picture of its GOP, the next
# IDR picture, the last), and the least PSNR (dB) of their decoded luma
# against the renders: sound builds read 45.94-46.14, the deblocking filter
# left out 44.68-45.01 (tests/torch_h264_planted_faults.py). The writer
# shares the decoder's prediction, so a prediction fault barely moves the
# PSNR (a 6-tap filter of taps 21 / 19: 45.94-46.14); the exerciser clips'
# digests (H264_EXERCISER_DIGESTS) catch those.
PHONE_H264_QP, PHONE_H264_GOP, PHONE_H264_REFS = 22, 12, 4
PHONE_H264_CHECKED = (0, 11, 12, 29)
PHONE_H264_MIN_PSNR = 45.5
# The phone clip as x264 codes it at its defaults (as ffmpeg runs it): High
# profile, CABAC, the 8x8 transform, an IDR picture every PHONE_H264_GOP
# frames, PHONE_H264_BFRAMES B pictures between anchors in a pyramid
# (bframes 3, b-pyramid normal: GopStructure), spatial direct, implicit B
# weights (weighted_bipred_idc 2), explicit P weights (weightp), up to
# PHONE_H264_REFS references, max_num_reorder_frames 2; otherwise the CAVLC
# clip's settings. Frames PHONE_H264_B_CHECKED (the IDR picture, a
# reference B, a non-reference B, the last P) are held to the CPU's and to
# the least luma PSNR PHONE_H264_B_MIN_PSNR against the renders: a sound
# build reads 46.5899 / 47.0849 / 47.2492 / 46.9674 dB, and the faults only
# B slices reach (temporal direct's scale, implicit weights, bS over list 0
# alone) read within 0.007 dB of it (tests/torch_h264_planted_faults.py):
# the B exerciser clips' digests catch those.
PHONE_H264_BFRAMES = 3
PHONE_H264_B_CHECKED = (0, 2, 3, 29)
PHONE_H264_B_MIN_PSNR = 46.5
# The Stray Scanner capture's rgb.mp4 (High profile, CABAC, the 8x8
# transform, as the app writes it; otherwise the H.264 phone clip's
# settings): the frames whose card reads are held to the CPU's, and the
# least PSNR (dB) of their decoded luma against the renders: sound builds
# read 46.4308-47.1598, the internal 8x8 edges filtered 46.3655 and intra
# 8x8 without its reference filter 46.3780 on frame 0, deblocking off
# 45.3974-46.1023 (tests/torch_h264_planted_faults.py).
STRAY_CHECKED = (0, 11, 12, 29)
STRAY_MIN_PSNR = 46.4
# The phone clips' CLI runs convert their first PHONE_CLI_FRAMES frames
# (their decode checks read all VIDEO_FRAMES; cut from 10 for the script's
# time limit when the HEVC run joined); the Stray Scanner run all.
PHONE_CLI_FRAMES = 5
# The H.264 exerciser clips at VGA (video.h264.Exerciser, seeded, on the
# integer-made frames of exerciser_planes, so that every host writes the
# same bytes): (name, frames, write_h264_mp4 options, Exerciser options,
# exerciser_planes' noise). Together they write every syntax path the
# writer counts, and (the High profile clips: CABAC with cabac_init_idc 0,
# 1 and 2, and CAVLC, each with the 8x8 transform on half the macroblocks
# and scaling lists, B pictures in some) code every CABAC context that I, P
# and B slices of progressive 4:2:0 pictures can read, under each of the
# four tables (video.h264.cabac_contexts_reachable). Their scaling lists:
# explicit ones (a run of equal values at the end coded by a nextScale of 0),
# default ones (useDefaultScalingMatrixFlag), and absent ones under fall-back
# rule A (each of the eight lists in some clip: SPS lists, or PPS lists
# without SPS lists) and rule B (each of the eight: PPS lists beside SPS
# lists).


def scaling_list(size: int, seed: int) -> Tuple[int, ...]:
    """An explicit scaling list of ``size`` weights 4-67, in scan order."""
    return tuple(4 + (37 * seed + 11 * j * j + 5 * j) % 64 for j in range(size))


H264_HIGH = dict(profile=100, transform_8x8=True, num_ref_frames=4)
H264_HIGH_PLANNER = dict(gop=6, t8x8=0.5)
H264_EXERCISER_CLIPS = (
    ("out_of_order", 12, dict(reorder=True, constrained_intra=True, chroma_qp_offset=-3),
     dict(gop=100), 1),
    ("mmco_reset", 12, dict(restriction=0, num_ref_frames=3), dict(gop=8, reset=True, mmco=0.8),
     1),
    ("poc_type_2", 12, dict(poc_type=2, profile=100, second_chroma_qp_offset=4), dict(gop=7), 1),
    ("cabac_sps_lists", 12,
     dict(H264_HIGH, cabac=True, scaling=dict(sps=[
         scaling_list(16, 1), scaling_list(16, 2), (20, 20, 20) + (33,) * 13, scaling_list(16, 4),
         scaling_list(16, 5), scaling_list(16, 6), scaling_list(64, 7), scaling_list(64, 8)])),
     dict(H264_HIGH_PLANNER, qp=26, init_idcs=(0,)), 24),
    ("cabac_fall_back_b", 12,
     dict(H264_HIGH, cabac=True, scaling=dict(
         sps=[None, scaling_list(16, 11), "default", None, None, scaling_list(16, 15), None,
              scaling_list(64, 17)],
         pps=[None, scaling_list(16, 21), None, "default", None, scaling_list(16, 25), None,
              "default"])),
     dict(H264_HIGH_PLANNER, qp=24, init_idcs=(1,)), 24),
    ("cabac_fall_back_a", 12,
     dict(H264_HIGH, cabac=True, scaling=dict(pps=[
         scaling_list(16, 31), None, None, None, scaling_list(16, 35), None,
         scaling_list(64, 37), None])),
     dict(H264_HIGH_PLANNER, qp=24, init_idcs=(2,)), 24),
    ("cavlc_8x8", 12,
     dict(H264_HIGH, scaling=dict(
         sps=[scaling_list(16, 41 + i) if i < 6 else scaling_list(64, 41 + i) for i in range(8)],
         pps=[scaling_list(16, 51), None, scaling_list(16, 53), None, scaling_list(16, 55), None,
              scaling_list(64, 57), None])),
     dict(H264_HIGH_PLANNER, qp=26), 24),
    # B pictures (ROADMAP item 9f-3): each B type and sub-type, both direct
    # modes with and without direct_8x8_inference, weighted_bipred_idc 0, 1
    # and 2, explicit P weights, B references (a pyramid), list 1's
    # modification, long-term references in list 1, list 1 starting as list
    # 0 (B anchors, all references in the past), and CABAC's B contexts
    # under each cabac_init_idc.
    ("b_cavlc_explicit", 12,
     dict(profile=77, weighted_pred=True, weighted_bipred=1, num_ref_frames=4),
     dict(gop=12, bframes=3, pyramid=True, weights=0.8, mmco=0.6, b_anchors=0.3), 1),
    ("b_cabac_implicit", 12,
     dict(H264_HIGH, cabac=True, weighted_bipred=2, direct_8x8_inference=False),
     dict(H264_HIGH_PLANNER, gop=12, bframes=2, pyramid=True, init_idcs=(0, 1, 2), qp=26), 24),
    ("b_cavlc_8x8_default", 12, dict(H264_HIGH, weighted_pred=True),
     dict(H264_HIGH_PLANNER, gop=12, bframes=3, weights=0.5, spatial=0.3, qp=26), 24),
)
# Each exerciser clip's SHA-256 (its first 16 hex digits): the file, and
# the BGR frames cv2 5.0.0 reads from it, in order (tests/test_torch_h264.py
# holds both to a fresh write and to cv2). On the card's host the writer
# must write these bytes and the captures, card and CPU, must read these
# frames: so the decoder built there gives FFmpeg's pixels, whatever fault
# its own writer would share with it (a fault in a prediction or a filter
# changes the written bytes, or the frames, or both).
H264_EXERCISER_DIGESTS = {
    "out_of_order": ("dbac47d6eec566e8", "920cc5ea84efeec4"),
    "mmco_reset": ("a60fc257a7a3b637", "6e0b150025343dbe"),
    "poc_type_2": ("eb092188f09ed853", "6fd8691ad6fbb8c4"),
    "cabac_sps_lists": ("a31a1973aec60be9", "85d969b5545cf27f"),
    "cabac_fall_back_b": ("4006ff8f91c0e905", "b5fd7ec725fc5c77"),
    "cabac_fall_back_a": ("55ee6b764787d553", "e41adf81eab337c5"),
    "cavlc_8x8": ("a143bc0ff73a6def", "d2266a2004ef9618"),
    "b_cavlc_explicit": ("61048b4597001fdf", "4a6eca4e593279ac"),
    "b_cabac_implicit": ("1d3648cd3920b43b", "cc6b5627e9341aa2"),
    "b_cavlc_8x8_default": ("aad380a94f83fc6c", "e30902d5c65db71f"),
}


# The HEVC exerciser clips at VGA (video.hevc.Exerciser, seeded, on the
# integer-made frames of exerciser_planes): (name, frames, write_hevc_mp4
# options, Exerciser options, exerciser_planes' noise). Together they write
# every syntax path the writer counts (every intra mode at each transform
# block size, NxN, the DST and each DCT size, transform skip, sign hiding,
# transquant bypass, PCM with the loop filter on and off, cu_qp_delta and
# the chroma QP offsets, SAO band offsets and each edge class, deblocking
# with offsets and off across slices, several slices a picture, CTBs of 16,
# 32 and 64, IDR, CRA and trailing pictures, hev1 with in-band parameter
# sets), code every CABAC context an I slice can read
# (video.hevc.contexts_reachable), and take each loop filter decision the
# decoder counts.
HEVC_EXERCISER_CLIPS = (
    ("ctb64_tools", 4,
     dict(ctb_log2=6, max_tb_log2=5, max_depth_intra=3, pcm=(8, 8, 3, 5, False),
          sign_hiding=True, transform_skip=True, transquant_bypass=True, cu_qp_delta_depth=2,
          cb_qp_offset=3, cr_qp_offset=-2, slice_chroma_offsets=True,
          deblocking=(True, False, 2, -1), init_qp=30),
     dict(ctb_log2=6, max_slices=4, slice_options=("qp", "sao", "deblocking", "across", "chroma")),
     24),
    ("ctb32_pcm_unfiltered", 4,
     dict(ctb_log2=5, max_tb_log2=4, max_depth_intra=1, pcm=(7, 5, 3, 4, True),
          transquant_bypass=True, across_slices=False, deblocking=(False, False, -3, 4),
          sign_hiding=True),
     dict(ctb_log2=5, max_slices=3, knobs=dict(pcm=150)), 1),
    ("ctb16_slices", 18,
     dict(ctb_log2=4, max_tb_log2=4, max_depth_intra=2, log2_max_poc_lsb=4, transform_skip=True,
          cu_qp_delta_depth=1, deblocking=(True, False, 0, 0), fourcc=b"hev1", in_band=True),
     dict(ctb_log2=4, max_slices=5, idr_every=17, cra=0.3, knobs=dict(transform_skip=500)), 24),
    ("ctb64_smooth", 3, dict(ctb_log2=6, max_tb_log2=5, max_depth_intra=0),
     dict(ctb_log2=6, max_slices=1, qp=36, knobs=dict(split_cu=150, split_tu=100, nxn=100)), 1),
    # P and B pictures (video.hevc.GopStructure): P pictures from up to three
    # anchors with B slices among them, AMP, weighted prediction, modified
    # lists, both CABAC tables, sets in the SPS and the headers, intra, PCM
    # and bypass units among inter ones, CTB 64.
    ("p_ctb64_tools", 8,
     dict(ctb_log2=6, max_tb_log2=5, max_depth_intra=1, max_depth_inter=3, amp=True,
          temporal_mvp=True, pcm=(8, 8, 3, 5, False), transquant_bypass=True,
          transform_skip=True, sign_hiding=True, cu_qp_delta_depth=2, cb_qp_offset=2,
          slice_chroma_offsets=True, deblocking=(True, False, 1, -1), weighted_pred=True,
          weighted_bipred=True, lists_modification=True, cabac_init_present=True,
          num_ref_default=(2, 1), rps_in_sps=3, init_qp=30),
     dict(ctb_log2=6, max_slices=3, cra=0.3, idr_every=6,
          slice_options=("qp", "sao", "deblocking", "across", "chroma"),
          knobs=dict(split_cu=600, pcm=40, bypass=40),
          inter=dict(bframes=0, max_refs=3, slices=("types", "num_ref", "modification",
                                                    "weights", "cabac_init", "max_merge",
                                                    "tmvp_off", "rps_in_header"))), 24),
    # A B pyramid of three between anchors, two sub-layers (TSA and STSA),
    # open GOPs (RASL pictures), pictures not output, mvd_l1_zero, each list
    # collocated, explicit bi-prediction weights, interSplitFlag, the
    # parallel merge level 8, POC LSBs of 4 bits, CTB 64.
    ("b_ctb64_layers", 18,
     dict(ctb_log2=6, max_tb_log2=5, max_depth_intra=2, max_depth_inter=0,
          log2_max_poc_lsb=4, temporal_mvp=True, weighted_pred=True, weighted_bipred=True,
          lists_modification=True, cabac_init_present=True, num_ref_default=(2, 2),
          rps_in_sps=6, output_flag=True, parallel_merge_log2=3, max_sub_layers=2,
          sign_hiding=True, deblocking=(True, False, 0, 0)),
     dict(ctb_log2=6, max_slices=4, cra=0.5, qp=32, knobs=dict(mv_range=160, split_cu=650),
          inter=dict(bframes=3, max_refs=2, sub_layers=True,
                     slices=("types", "num_ref", "modification", "weights", "mvd_l1_zero",
                             "cabac_init", "collocated", "max_merge", "output_off",
                             "rps_in_header"))), 1),
    # NxN inter units (16x16 the smallest coding unit), the parallel merge
    # level 16, RADL pictures (closed GOPs) and an IDR picture mid-clip,
    # units without a residual at QP 40, CTB 16.
    ("b_ctb16_nxn", 9,
     dict(ctb_log2=4, min_cb_log2=4, max_tb_log2=4, max_depth_intra=1, max_depth_inter=1,
          temporal_mvp=True, parallel_merge_log2=4, num_ref_default=(1, 1), init_qp=40,
          cabac_init_present=True),
     dict(ctb_log2=4, max_slices=2, cra=0.6, idr_every=6, qp=40,
          knobs=dict(part=600, split_cu=300, merge=300, skip=100, dead_zone=600),
          inter=dict(bframes=2, max_refs=2, open_gop=False,
                     slices=("types", "cabac_init", "collocated", "max_merge"))), 1),
    # Long-term references (the last IRAP picture, once out of the short-term
    # window; by their LSBs, from the SPS's candidates or with their MSBs,
    # POC LSBs of 4 bits), BLA pictures with RADL pictures, IDR and BLA
    # pictures that drop the pictures not yet output, CTB 32.
    ("p_ctb32_long_term", 18,
     dict(ctb_log2=5, max_tb_log2=5, max_depth_intra=1, max_depth_inter=1, log2_max_poc_lsb=4,
          temporal_mvp=True, lt_in_sps=2, num_ref_default=(2, 1), weighted_pred=True,
          lists_modification=True),
     dict(ctb_log2=5, max_slices=2, cra=0.35, bla=0.6, idr_every=8,
          inter=dict(bframes=1, max_refs=1, long_term=True,
                     slices=("types", "num_ref", "modification", "weights", "lt_msb",
                             "prior_pics"))), 24),
)
# Each HEVC exerciser clip's SHA-256 (its first 16 hex digits): the file,
# and the BGR frames cv2 5.0.0 reads from it (tests/test_torch_hevc_intra.py
# holds both to a fresh write and to cv2), as H264_EXERCISER_DIGESTS.
HEVC_EXERCISER_DIGESTS = {
    "ctb64_tools": ("22b82b3d3d477e2e", "2bc21b23a1c551dd"),
    "ctb32_pcm_unfiltered": ("d7490de8d266ff88", "d3bdaf0c3acdb79e"),
    "ctb16_slices": ("698d21c942e68f38", "fb1a6517351379ac"),
    "ctb64_smooth": ("4cf464021b87bf6e", "9a3b10c3fae811be"),
    "p_ctb64_tools": ("06037093c0c335b9", "855a4ff6a106d534"),
    "b_ctb64_layers": ("b7c6bb760faa9891", "8c0ed792241ec0a7"),
    "b_ctb16_nxn": ("a0584ccdfa0c53cb", "6e8d844beb2981c0"),
    "p_ctb32_long_term": ("ff890bc002a3a5ec", "41c52010cfbc8e81"),
}
# The HEVC phone clip (video.hevc.write_hevc_mp4, InterPlanner): the first
# PHONE_HEVC_FRAMES renders as x265's medium preset codes them (CTB 64, P
# anchors every 5 pictures from up to three before them, a pyramid of four
# B pictures between, an open-GOP CRA picture at 10 with RASL pictures 6-9,
# weightp tables, TMVP, MaxNumMergeCand 3, SAO, sign hiding), inter units of
# 16x16 merged or searched to the nearest prediction, QP PHONE_HEVC_QP (B
# pictures 2 more), PHONE_HEVC_SLICES slices a picture; the frames whose
# card reads are held to the CPU's (the IDR, a P, a RASL B and the P after
# the CRA), and the least PSNR (dB) of their decoded luma against the
# renders. The writer predicts as the decoder does, so the planted faults
# (tests/torch_hevc_planted_faults.py --clips phone, readings in PERF.md)
# move it little: the floor stops gross faults, the digests the others.
# PHONE_HEVC_DIGESTS: the file's SHA-256 and that of the BGR frames cv2
# 5.0.0 reads from it (first 16 hex digits; tests/test_torch_hevc_phone.py
# holds both to a fresh write, to cv2 and to the port on the CPU).
PHONE_HEVC_QP, PHONE_HEVC_SLICES, PHONE_HEVC_FRAMES = 24, 4, 12
PHONE_HEVC_CHECKED = (0, 5, 6, 11)
PHONE_HEVC_MIN_PSNR = 45.7
PHONE_HEVC_DIGESTS = ("0b07b92ce5e7828f", "71e287332b8f7c0a")


def nvdec_caps_log() -> dict:
    """cuvidGetDecoderCaps for 8-bit 4:2:0 H.264, HEVC, MPEG-4, VP9 and AV1 at
    1920 x 1440 on the card, or the error each call gave; logs only."""
    from hive_tpu_torch.video import nvdec

    caps = {}
    for name, codec in nvdec.CODECS.items():
        try:
            caps[name] = nvdec.decoder_caps("cuda:0", codec, STRAY_W, STRAY_H)
        except nvdec.NvdecError as e:
            caps[name] = str(e)
    return caps


def nvdec_parser_log(folder: str) -> dict:
    """What NVDEC's parser reports for an I_PCM stream (1920x1080, cropped
    from 1088 lines), which checks the parser's structures even where the
    decoder cannot be made; logs only."""
    from hive_tpu_torch.video import h264, mp4, nvdec

    path = os.path.join(folder, "parser_check.mp4")
    h264.write_h264_mp4(path, video_planes(1, PHONE_W, PHONE_H, SEED),
                        h264.PcmPlanner(PHONE_W, PHONE_H))
    track = mp4.read_track(path)
    length_size, sps, pps = mp4.parse_avcc(track.config)
    with open(path, "rb") as f:
        f.seek(int(track.offsets[0]))
        units = mp4.split_nal_units(f.read(int(track.sizes[0])), length_size)
    try:
        decoder = nvdec.NvdecDecoder("cuda:0")
    except nvdec.NvdecError as e:
        return dict(error=str(e))
    try:
        decoder.decode(mp4.annex_b(sps + pps + units), 0)
        error = None
    except nvdec.NvdecError as e:
        error = str(e)
    finally:
        decoder.close()
    return dict(reported=decoder.reported, error=error)


def video_planes(num_frames: int, width: int, height: int, seed: int):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (height, width), dtype=np.uint8),
             rng.integers(0, 256, (height // 2, width // 2), dtype=np.uint8),
             rng.integers(0, 256, (height // 2, width // 2), dtype=np.uint8))
            for _ in range(num_frames)]


def write_stray_capture(base: str, num_frames: int) -> Tuple[dict, dict]:
    """A Stray Scanner capture at the app's sizes: rgb.mp4 (H.264 as the app
    writes it: High profile, CABAC, the 8x8 transform; the textured wall,
    ``write_h264_mp4`` with the wall's motion as the phone clip's), uint16
    millimetre depth and 0-2 confidence PNGs, camera_matrix.csv and
    odometry.csv, the first pose rolled -90 degrees (portrait). Returns the
    writer's counts and the rendered luma of frames STRAY_CHECKED."""
    from concurrent.futures import ThreadPoolExecutor

    from scipy.spatial.transform import Rotation

    from hive_tpu_torch.video import color, h264

    os.makedirs(os.path.join(base, "depth"))
    os.makedirs(os.path.join(base, "confidence"))
    texture = wall_texture()
    K = wall_camera() * np.array([[STRAY_W / FEATURE_W], [STRAY_W / FEATURE_W], [1.0]])
    poses = wall_trajectory(num_frames)

    def planes(i):
        return color.rgb_to_yuv420(render_wall(texture, poses[i], K, STRAY_W, STRAY_H)[0])

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        frames = list(pool.map(planes, range(num_frames)))
    totals = h264.write_h264_mp4(
        os.path.join(base, "rgb.mp4"), frames,
        h264.MotionPlanner(STRAY_W, STRAY_H,
                           lambda i, r: wall_motion_qpel(poses, K, i, r, STRAY_W, STRAY_H),
                           gop=PHONE_H264_GOP, qp=PHONE_H264_QP, refs=PHONE_H264_REFS,
                           t8x8=True),
        init_qp=PHONE_H264_QP, num_ref_frames=PHONE_H264_REFS, restriction=0, profile=100,
        cabac=True, transform_8x8=True)
    rendered = {i: frames[i][0] for i in STRAY_CHECKED if i < num_frames}
    rng = np.random.default_rng(SEED)
    for i in range(num_frames):
        depth = np.full(STRAY_DEPTH_HW, 2000, np.uint16) + rng.integers(0, 5, STRAY_DEPTH_HW)
        write_png(os.path.join(base, "depth", f"{i:06d}.png"), depth.astype(np.uint16))
        write_png(os.path.join(base, "confidence", f"{i:06d}.png"),
                  rng.choice([1, 2, 2, 2], STRAY_DEPTH_HW).astype(np.uint8))
    np.savetxt(os.path.join(base, "camera_matrix.csv"), K, delimiter=",")
    with open(os.path.join(base, "odometry.csv"), "w") as f:
        f.write("timestamp, frame, x, y, z, qx, qy, qz, qw\n")
        for i in range(num_frames):
            q = Rotation.from_euler("xyz", [0.0, 0.0, -np.pi / 2]).as_quat()
            f.write(", ".join(repr(float(x)) for x in (i / 30, i, 0.01 * i, 0.0, 0.0, *q))
                    + "\n")
    return {name: value for name, value in totals.items() if name != "coverage"}, rendered


def check_stray_capture(device, base: str, rendered: dict) -> dict:
    """The Stray Scanner capture's rgb.mp4 read on the card against the CPU:
    High profile, CABAC and the 8x8 transform as the app writes it; its
    size, count and rate; frames STRAY_CHECKED equal, their decoded luma at
    least STRAY_MIN_PSNR against the renders; the host decode (native) ms
    of its 1920x1440 IDR picture and of a P picture, beside the card's
    name and power limit."""
    from hive_tpu_torch.video import h264, h264_bits, mp4
    from hive_tpu_torch.video.capture import VideoCapture

    video = os.path.join(base, "rgb.mp4")
    card, cpu = VideoCapture(video, device=device), VideoCapture(video, device="cpu")
    sps = h264.parse_sps(h264_bits.unescape(card.sps_units[0]))
    pps = h264.parse_pps(h264_bits.unescape(card.pps_units[0]))
    coding = (sps["profile"], pps["cabac"], pps["transform_8x8"])
    if coding != (100, 1, 1):
        raise AssertionError(f"[video] the Stray capture is (profile, CABAC, 8x8) {coding}")
    expected = (STRAY_W, STRAY_H, VIDEO_FRAMES, 30.0, mp4.H264)
    for capture in (card, cpu):
        got = (capture.width, capture.height, capture.frame_count, capture.fps, capture.codec)
        if got != expected:
            raise AssertionError(f"[video] the Stray capture reads as {got}, not {expected}")
    psnr = {}
    for index in STRAY_CHECKED:
        if not torch.equal(card.frame(index).cpu(), cpu.frame(index)):
            raise AssertionError(f"[video] the Stray capture's frame {index} on the card "
                                 f"differs from the CPU's")
        y = next(card.planes(index, index + 1))[0].cpu().numpy()
        psnr[index] = psnr_db(y, rendered[index])
        if not psnr[index] >= STRAY_MIN_PSNR:
            raise AssertionError(f"[video] the Stray capture's frame {index} decodes "
                                 f"{psnr[index]:.3f} dB PSNR against the luma it was written "
                                 f"from, under {STRAY_MIN_PSNR} dB: the decoder is wrong on "
                                 f"this host")
    units, _, (idr_ms, p_ms) = h264_decode_ms(card)
    result = dict(luma_psnr_db=psnr, idr_bytes=sum(map(len, units[0])),
                  p_bytes=sum(map(len, units[1])), idr_decode_ms=idr_ms, p_decode_ms=p_ms)
    log(f"[video] Stray capture rgb.mp4 (High profile, CABAC, the 8x8 transform, "
        f"{STRAY_W}x{STRAY_H}): size, count and rate as written; frames {STRAY_CHECKED} on the "
        f"card equal the CPU's, their luma at {', '.join(f'{v:.4f}' for v in psnr.values())} "
        f"dB PSNR against the renders (floor {STRAY_MIN_PSNR}); host decode {idr_ms:.3f} ms "
        f"the IDR picture ({result['idr_bytes']} B), {p_ms:.3f} ms a P picture "
        f"({result['p_bytes']} B) (native, one thread) on {nvidia_smi_line()}")
    return result


def check_video(device, launches, tmp: str) -> dict:
    """[video]: the demuxer, the decoders and the conversion on the card, then
    a user's plain videos and Stray Scanner capture through the CLI."""
    from hive_tpu_torch.image_processing import (ROTATE_90_CLOCKWISE, resize_linear_u8,
                                                 rotate)
    from hive_tpu_torch.video import color, h264
    from hive_tpu_torch.video.capture import VideoCapture

    phase_start = time.perf_counter()
    folder = os.path.join(tmp, "video")
    os.makedirs(folder)
    results = {}
    for index, (name, count, width, height, options) in enumerate(VIDEO_FIXTURES):
        planes = video_planes(count, width, height, SEED + index)
        path = os.path.join(folder, f"{name}.mp4")
        h264.write_h264_mp4(path, planes, h264.PcmPlanner(width, height), **options)
        cpu, card = VideoCapture(path, device="cpu"), VideoCapture(path, device=device)
        for capture in (cpu, card):
            if (capture.width, capture.height, capture.frame_count, capture.fps) != (
                    width, height, count, 30.0):
                raise AssertionError(f"[video] the demuxer reads {name} as {capture.width}x"
                                     f"{capture.height}, {capture.frame_count} frames at "
                                     f"{capture.fps} fps")
        start = time.perf_counter()
        decoded = list(cpu.planes())
        cpu_ms = 1e3 * (time.perf_counter() - start) / count
        torch.cuda.synchronize()
        start = time.perf_counter()
        on_card = list(card.planes())
        torch.cuda.synchronize()
        card_ms = 1e3 * (time.perf_counter() - start) / count
        for source, got in (("CPU", decoded), ("card", on_card)):
            if len(got) != count or not all(
                    np.array_equal(g.cpu().numpy(), w)
                    for pictures, want in zip(got, planes) for g, w in zip(pictures, want)):
                raise AssertionError(f"[video] the {source} capture's planes of {name} differ "
                                     f"from the seeded samples")
        # The card's conversion against the CPU's on the same planes.
        torch.cuda.reset_peak_memory_stats(device)
        y, u, v = (torch.from_numpy(p) for p in planes[0])
        on_device = [p.to(device) for p in (y, u, v)]
        if not torch.equal(color.yuv420_to_bgr(*on_device).cpu(), color.yuv420_to_bgr(y, u, v)):
            raise AssertionError(f"[video] the card's BGR of {name} differs from the CPU's")
        ms, kernels = device_profile(lambda: color.yuv420_to_bgr(*on_device), reps=10,
                                     warmup=2)
        results[name] = dict(cpu_ms_per_frame=cpu_ms, card_ms_per_frame=card_ms,
                             conversion_ms=ms, conversion_kernels=kernels,
                             peak_bytes=int(torch.cuda.max_memory_allocated(device)))
        log(f"[video] {name}: {count} I_PCM frames {width}x{height} at 30 fps, the demuxer's "
            f"properties as written; H264Decoder's planes exact on the CPU ({cpu_ms:.3f} ms a "
            f"frame) and through the card's capture (host decode, then the copy: "
            f"{card_ms:.3f} ms a frame); the card's conversion equals the CPU's, {ms:.6f} ms "
            f"device in {kernels} kernels, peak {results[name]['peak_bytes']} B")
    parser = nvdec_parser_log(folder)
    results["nvdec_parser"] = parser
    log(f"[video] NVDEC's parser alone on a 1920x1080 I_PCM stream (coded 1088 lines; NVDEC is "
        f"not on the decode path, ROADMAP item 9b): {parser}")
    results["exerciser"] = check_h264_exerciser(device, folder)
    results["hevc_exerciser"] = check_hevc_exerciser(device, folder)

    # The card's rotation and resize at the user runs' shapes, against the CPU.
    rng = np.random.default_rng(SEED)
    for name, (height, width), rotation, target in (
            ("phone", (PHONE_H, PHONE_W), None, (360, 640)),
            ("stray", (STRAY_H, STRAY_W), ROTATE_90_CLOCKWISE, (640, 480))):
        frame = torch.from_numpy(rng.integers(0, 256, (height, width, 3), dtype=np.uint8))
        on_card = frame.to(device)

        def card_step():
            turned = on_card if rotation is None else rotate(on_card, rotation)
            return resize_linear_u8(turned, target[1], target[0])

        want = resize_linear_u8(frame if rotation is None else rotate(frame, rotation),
                                target[1], target[0])
        if not torch.equal(card_step().cpu(), want):
            raise AssertionError(f"[video] the card's rotate + resize ({name}) differs from "
                                 f"the CPU's")
        ms, kernels = device_profile(card_step, reps=10, warmup=2)
        results[f"{name}_rotate_resize"] = dict(ms=ms, kernels=kernels)
        log(f"[video] {name}: {'rotate 90 degrees clockwise, ' if rotation is not None else ''}"
            f"resize {width}x{height} -> {target[1]}x{target[0]} on the card equals the CPU's, "
            f"{ms:.6f} ms device in {kernels} kernels")

    # A user's plain video and Stray Scanner capture through the CLI: the
    # phone clip as Motion JPEG, as MPEG-4 Part 2 (what cv2's mp4v writer
    # makes), as H.264 (CAVLC, and as x264 codes it, with B pictures) and as
    # x265-shaped HEVC (P and B pictures), and the capture's H.264 rgb.mp4,
    # all decoded on the host for every device; a clip of fields and an HEVC
    # clip with scaling lists refused.
    clip = os.path.join(folder, "phone.mp4")
    mpeg4_clip = os.path.join(folder, "phone_mpeg4.mp4")
    h264_clip = os.path.join(folder, "phone_h264.mp4")
    h264_b_clip = os.path.join(folder, "phone_h264_b.mp4")
    hevc_clip = os.path.join(folder, "phone_hevc.mp4")
    stray = os.path.join(folder, "stray")
    results["mjpeg"] = check_mjpeg_clip(device, clip)
    results["mpeg4"] = check_mpeg4_clip(device, mpeg4_clip)
    results["h264"] = check_h264_clip(device, h264_clip)
    results["h264_b"] = check_h264_b_clip(device, h264_b_clip)
    results["hevc"] = check_hevc_clip(device, hevc_clip)
    results["field_refusal"] = check_field_refusal(folder)
    results["hevc_refusal"] = check_hevc_refusal(folder)
    start = time.perf_counter()
    results["stray_writer"], rendered = write_stray_capture(stray, VIDEO_FRAMES)
    log(f"[video] Stray Scanner capture written ({VIDEO_FRAMES} frames, rgb.mp4 H.264 High "
        f"profile, CABAC, the 8x8 transform, {STRAY_W}x{STRAY_H}, "
        f"{os.path.getsize(os.path.join(stray, 'rgb.mp4'))} B) in "
        f"{time.perf_counter() - start:.1f} s; writer counts {results['stray_writer']}")
    results["stray_capture"] = check_stray_capture(device, stray, rendered)
    pose_depth = ["--estimate_pose", "--estimate_depth", "--binary_path",
                  os.path.join(folder, "no_colmap")]
    runs = [("phone", clip, pose_depth, (360, 640), PHONE_CLI_FRAMES),
            ("phone_mpeg4", mpeg4_clip, pose_depth, (360, 640), PHONE_CLI_FRAMES),
            ("phone_h264_b", h264_b_clip, pose_depth, (360, 640), PHONE_CLI_FRAMES),
            ("phone_hevc", hevc_clip, pose_depth, (360, 640), PHONE_CLI_FRAMES),
            ("stray", stray, [], (640, 480), VIDEO_FRAMES)]
    results["runs"] = run_video_conversions(device, launches, folder, runs)
    log(f"[video] the phase took {time.perf_counter() - phase_start:.1f} s")
    return results


def check_h264_exerciser(device, folder: str) -> dict:
    """The H.264 exerciser clips (H264_EXERCISER_CLIPS, 640x480): every
    syntax path the writer counts written at least once over them, and every
    CABAC context that I, P and B slices can read coded under each of the four
    tables; each file the bytes of H264_EXERCISER_DIGESTS, and its frames
    read on the card and on the CPU both the frames cv2 reads (by their
    digest)."""
    from hive_tpu_torch.video import h264
    from hive_tpu_torch.video.capture import VideoCapture

    totals, result = {}, {}
    contexts = np.zeros((4, 1024), np.int64)
    for index, (name, count, *_) in enumerate(H264_EXERCISER_CLIPS):
        start = time.perf_counter()
        path, stats = write_h264_exerciser(folder, index)
        write_s = time.perf_counter() - start
        want = H264_EXERCISER_DIGESTS[name]
        got = (file_digest(path),
               frames_digest(VideoCapture(path, device=device).frames()),
               frames_digest(VideoCapture(path, device="cpu").frames()))
        if got != (*want, want[1]):
            raise AssertionError(f"[video] exerciser {name}: file / card frames / CPU frames "
                                 f"digests {got}, not {want}: the writer or decoder built here "
                                 f"is not the one the tests hold to cv2")
        for key, value in stats.items():
            if key != "coverage":
                totals[key] = totals.get(key, 0) + value
        contexts += stats["coverage"]["cabac_contexts"]
        result[name] = dict(write_s=write_s, bytes=os.path.getsize(path), digests=got[:2])
    missing = [key for key, value in totals.items() if value == 0]
    if missing:
        raise AssertionError(f"[video] the exerciser clips wrote no {missing}")
    reachable = h264.cabac_contexts_reachable()
    unread = [(table, int(ctx)) for table, ctx in zip(*np.nonzero(reachable & (contexts == 0)))]
    if unread:
        raise AssertionError(f"[video] the exerciser clips coded no decision in the CABAC "
                             f"contexts (table, ctxIdx) {unread}")
    result["counts"] = totals
    result["contexts_read"] = int(reachable.sum())
    log(f"[video] H.264 exerciser clips {[c[0] for c in H264_EXERCISER_CLIPS]} (640x480; "
        f"CAVLC and CABAC, I, P and B, the 8x8 transform, scaling lists, weighted prediction): "
        f"each file and its "
        f"frames on the card and on the CPU hash to the digests of cv2's read; every path "
        f"written ({totals}); all {result['contexts_read']} reachable (table, ctxIdx) CABAC "
        f"contexts coded, the least {int(contexts[reachable].min())} times")
    return result


def check_hevc_exerciser(device, folder: str) -> dict:
    """The HEVC exerciser clips (HEVC_EXERCISER_CLIPS, 640x480): every path
    the writer counts written at least once over them, every context I, P
    and B slices can read coded under each initType; each file the bytes of
    HEVC_EXERCISER_DIGESTS, and its frames read on the card and on the CPU
    both the frames cv2 reads (by their digest)."""
    from hive_tpu_torch.video import hevc
    from hive_tpu_torch.video.capture import VideoCapture

    totals, result = {}, {}
    contexts = np.zeros((3, hevc.NUM_CONTEXTS), np.int64)
    for index, (name, count, *_) in enumerate(HEVC_EXERCISER_CLIPS):
        start = time.perf_counter()
        path, stats = write_hevc_exerciser(folder, index)
        write_s = time.perf_counter() - start
        want = HEVC_EXERCISER_DIGESTS.get(name)
        got = (file_digest(path),
               frames_digest(VideoCapture(path, device=device).frames()),
               frames_digest(VideoCapture(path, device="cpu").frames()))
        if want is None or got != (*want, want[1]):
            raise AssertionError(f"[video] HEVC exerciser {name}: file / card frames / CPU "
                                 f"frames digests {got}, not {want}: the writer or decoder "
                                 f"built here is not the one the tests hold to cv2")
        for key, value in stats.items():
            if key != "contexts":
                totals[key] = totals.get(key, 0) + value
        contexts += stats["contexts"]
        result[name] = dict(write_s=write_s, bytes=os.path.getsize(path), digests=got[:2])
    missing = [key for key, value in totals.items() if value == 0]
    if missing:
        raise AssertionError(f"[video] the HEVC exerciser clips wrote no {missing}")
    reachable = hevc.contexts_reachable()
    unread = [(int(t), int(c)) for t, c in zip(*np.nonzero(reachable & (contexts == 0)))]
    if unread:
        raise AssertionError(f"[video] the HEVC exerciser clips coded no decision in the "
                             f"(initType, context) {unread}")
    result["counts"] = totals
    result["contexts_read"] = int(reachable.sum())
    log(f"[video] HEVC exerciser clips {[c[0] for c in HEVC_EXERCISER_CLIPS]} (640x480, "
        f"Main profile, intra clips with CTBs of 16, 32 and 64, P and B clips in GOPs): each "
        f"file and its frames on the card and on the CPU hash to the digests of cv2's read; "
        f"every path written; all {result['contexts_read']} reachable (initType, context) "
        f"pairs coded, the least {int(contexts[reachable].min())} times")
    return result


def write_hevc_exerciser(folder: str, index: int) -> Tuple[str, dict]:
    """HEVC exerciser clip ``index`` of HEVC_EXERCISER_CLIPS written into
    ``folder``: its path and the writer's counts."""
    from hive_tpu_torch.video import hevc

    name, count, options, planner, noise = HEVC_EXERCISER_CLIPS[index]
    path = os.path.join(folder, f"hevc_exerciser_{name}.mp4")
    stats = hevc.write_hevc_mp4(path, exerciser_planes(count, 640, 480, SEED + 50 + index, noise),
                                hevc.Exerciser(640, 480, SEED + 50 + index, **planner),
                                **options)
    return path, stats


def write_hevc_scaling_list_clip(folder: str) -> str:
    """A 64x64 HEVC clip whose SPS asks for scaling lists
    (scaling_list_enabled_flag, the default lists): the port refuses it,
    naming ROADMAP item 9c-3."""
    from hive_tpu_torch.video import hevc, mp4

    source = os.path.join(folder, "hevc_intra_source.mp4")
    hevc.write_hevc_mp4(source, video_planes(2, 64, 64, SEED), hevc.IntraPlanner(64, 64))
    track = mp4.read_track(source)
    _, (vps, _, pps) = hevc.parse_hvcc(track.config)
    sps = hevc.encode_sps(64, 64, scaling_list=True)
    with open(source, "rb") as f:
        samples = []
        for offset, size in zip(track.offsets, track.sizes):
            f.seek(int(offset))
            samples.append(f.read(int(size)))
    clip = os.path.join(folder, "hevc_scaling_lists.mp4")
    entry = mp4.visual_entry(b"hvc1", 64, 64, mp4.box(b"hvcC", hevc.hvcc_record(vps, sps, pps)))
    mp4.write_mp4(clip, entry, samples, width=64, height=64, timescale=30, durations=[1, 1],
                  sync=[True, True])
    return clip


def check_hevc_refusal(folder: str) -> dict:
    """The HEVC clip with scaling lists: the CLI refuses it when the
    capture opens, naming scaling lists and ROADMAP Queue 1 item 9c-3,
    before it writes anything."""
    from hive_tpu_torch.video import mp4

    clip = write_hevc_scaling_list_clip(folder)
    out = os.path.join(folder, "hevc_scaling_converted")
    argv = ["hive_tpu_torch", "--dataset_path", clip, "--output_path", out, "--estimate_pose",
            "--estimate_depth", "--webxr_path", out + "_webxr", "--log_file", out + ".log"]
    try:
        with mock.patch.object(sys, "argv", argv):
            runpy.run_module("hive_tpu_torch", run_name="__main__", alter_sys=True)
    except mp4.UnsupportedVideoError as e:
        if "scaling lists" not in str(e) or "Queue 1 item 9c-3" not in str(e):
            raise
        message = str(e)
    else:
        raise AssertionError("[video] the CLI converted an HEVC clip with scaling lists")
    if os.path.exists(out):
        raise AssertionError(f"[video] the refused HEVC clip left {out}")
    log(f"[video] the CLI refuses an HEVC clip with scaling lists before writing anything: "
        f"{message}")
    return dict(message=message)


def write_h264_exerciser(folder: str, index: int) -> Tuple[str, dict]:
    """Exerciser clip ``index`` of H264_EXERCISER_CLIPS written into
    ``folder``: its path and the writer's counts."""
    from hive_tpu_torch.video import h264

    name, count, options, planner, noise = H264_EXERCISER_CLIPS[index]
    path = os.path.join(folder, f"exerciser_{name}.mp4")
    stats = h264.write_h264_mp4(path, exerciser_planes(count, 640, 480, SEED + index, noise),
                                h264.Exerciser(640, 480, SEED + index, **planner), **options)
    return path, stats


def exerciser_planes(count: int, width: int, height: int, seed: int, noise: int = 1):
    """``count`` 4:2:0 frames made by integer arithmetic alone, so every
    host makes the same bytes: each plane a seeded grid of levels, one a
    macroblock, blended bilinearly between them (smooth, so the deblocking
    filter acts), with +-1 of seeded noise, its window sliding 4 luma
    columns and 2 rows a frame. With ``noise`` above 1 the noise's
    amplitude is seeded per macroblock, 0 (half of them) to ``noise``: flat
    macroblocks beside dense ones, whose residuals fill every coefficient
    position; and the chroma grid's levels are a macroblock pair apart and
    near grey (112-143)."""
    rng = np.random.default_rng(seed)

    def upsample(grid, s):
        f = np.arange(s)
        rows = (grid[:, :-1, None] * (s - f) + grid[:, 1:, None] * f).reshape(len(grid), -1)
        out = rows[:-1, None, :] * (s - f)[None, :, None] + rows[1:, None, :] * f[None, :, None]
        return out.reshape(-1, rows.shape[1])

    planes = []
    for k, (h, w) in enumerate(((height, width), (height // 2, width // 2),
                                (height // 2, width // 2))):
        scale = 16 if k == 0 or noise > 1 else 8
        low, high = (112, 144) if k and noise > 1 else (24, 232)
        grid = rng.integers(low, high, (h // scale + count // 8 + 3, w // scale + count // 2 + 3))
        canvas = upsample(grid.astype(np.int64), scale)
        planes.append((canvas, scale * scale))
    frames = []
    for i in range(count):
        frame = []
        for k, (canvas, norm) in enumerate(planes):
            dy, dx = (2 * i, 4 * i) if k == 0 else (i, 2 * i)
            h, w = (height, width) if k == 0 else (height // 2, width // 2)
            level = (canvas[dy:dy + h, dx:dx + w] + norm // 2) // norm
            if noise > 1:
                block = 16 if k == 0 else 8
                amplitude = np.repeat(np.repeat(np.maximum(0, rng.integers(
                    -noise, noise + 1, (h // block, w // block))), block, 0), block, 1)
                grain = (rng.integers(-noise, noise + 1, (h, w)) * amplitude) // noise
            else:
                grain = rng.integers(-1, 2, (h, w))
            frame.append(np.clip(level + grain, 0, 255).astype(np.uint8))
        frames.append(tuple(frame))
    return frames


def file_digest(path: str) -> str:
    """The first 16 hex digits of a file's SHA-256."""
    import hashlib

    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:16]


def frames_digest(frames) -> str:
    """The first 16 hex digits of the SHA-256 of frames' bytes, in order
    (tensors on any device, or arrays)."""
    import hashlib

    digest = hashlib.sha256()
    for frame in frames:
        frame = frame.cpu().numpy() if isinstance(frame, torch.Tensor) else frame
        digest.update(np.ascontiguousarray(frame).tobytes())
    return digest.hexdigest()[:16]


def field_sps(width: int, height: int) -> bytes:
    """A Baseline SPS of ``width`` x ``height`` (multiples of 16 and 32)
    whose pictures are fields (frame_mbs_only_flag 0)."""
    from hive_tpu_torch.video import h264_bits

    w = h264_bits.BitWriter().u(8, 66).u(8, 0).u(8, 51).ue(0).ue(4).ue(0).ue(12).ue(1).u(1, 0)
    w.ue(width // 16 - 1).ue(height // 32 - 1).u(1, 0).u(1, 0).u(1, 1).u(1, 0).u(1, 0)
    return h264_bits.nal_unit(3, h264_bits.NAL_SPS, np.frombuffer(w.align(True), np.uint8))


def check_field_refusal(folder: str) -> dict:
    """A small H.264 clip whose SPS codes fields: the CLI refuses it when the
    capture opens, naming fields and ROADMAP Queue 1 item 9f-4, before it
    writes anything."""
    from hive_tpu_torch.video import h264, mp4

    source = os.path.join(folder, "field_source.mp4")
    h264.write_h264_mp4(source, video_planes(3, 64, 64, SEED),
                        h264.Exerciser(64, 64, SEED, gop=3, mmco=0))
    track = mp4.read_track(source)
    length, _, pps = mp4.parse_avcc(track.config)
    with open(source, "rb") as f:
        samples = []
        for offset, size in zip(track.offsets, track.sizes):
            f.seek(int(offset))
            samples.append(f.read(int(size)))
    clip = os.path.join(folder, "fields.mp4")
    mp4.write_mp4(clip, mp4.avc1_entry(64, 64, field_sps(64, 64), pps[0]), samples, width=64,
                  height=64, timescale=30, durations=[1] * len(samples), sync=[True, False, False])
    out = os.path.join(folder, "fields_converted")
    argv = ["hive_tpu_torch", "--dataset_path", clip, "--output_path", out, "--estimate_pose",
            "--estimate_depth", "--webxr_path", out + "_webxr", "--log_file", out + ".log"]
    try:
        with mock.patch.object(sys, "argv", argv):
            runpy.run_module("hive_tpu_torch", run_name="__main__", alter_sys=True)
    except mp4.UnsupportedVideoError as e:
        if "fields or MBAFF" not in str(e) or "Queue 1 item 9f-4" not in str(e):
            raise
        message = str(e)
    else:
        raise AssertionError("[video] the CLI converted a clip of fields")
    if os.path.exists(out):
        raise AssertionError(f"[video] the refused field clip left {out}")
    log(f"[video] the CLI refuses an H.264 clip of fields before writing anything: {message}")
    return dict(message=message)


def write_phone_clip(path: str) -> float:
    """The phone clip: VIDEO_FRAMES 1920x1080 renders of the textured wall
    (the camera sliding 1 cm a frame), each a baseline 4:2:0 JPEG of
    quality PHONE_JPEG_QUALITY (``encode_jpeg``, on host threads) in an
    ``mp4v`` / 0x6C track at 30 fps, as cv2's MJPG writer stores Motion
    JPEG. Returns the seconds it took."""
    from concurrent.futures import ThreadPoolExecutor

    from hive_tpu_torch.image_codecs import encode_jpeg
    from hive_tpu_torch.video import mp4

    start = time.perf_counter()
    texture, K = wall_texture(), wall_camera() * np.array([[3.0], [3.0], [1.0]])
    poses = wall_trajectory(VIDEO_FRAMES)

    def sample(i):
        return encode_jpeg(render_wall(texture, poses[i], K, PHONE_W, PHONE_H)[0],
                           PHONE_JPEG_QUALITY)

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        samples = list(pool.map(sample, range(VIDEO_FRAMES)))
    mp4.write_mp4(path, mp4.mjpeg_entry(PHONE_W, PHONE_H), samples, width=PHONE_W,
                  height=PHONE_H, timescale=30, durations=[1] * VIDEO_FRAMES)
    return time.perf_counter() - start


def check_mjpeg_clip(device, clip: str) -> dict:
    """The Motion JPEG phone clip read on the card against the CPU: the
    demuxer's size, count and rate, frames 0 and the last equal; the host
    decode (native, FFmpeg's simple IDCT) ms a frame, the card's 4:2:0 ->
    BGR conversion device ms and kernels, and a ``frames()`` loop's ms a
    frame on the card."""
    from hive_tpu_torch.video import color, mjpeg, mp4
    from hive_tpu_torch.video.capture import VideoCapture

    write_s = write_phone_clip(clip)
    card, cpu = VideoCapture(clip, device=device), VideoCapture(clip, device="cpu")
    expected = (PHONE_W, PHONE_H, VIDEO_FRAMES, 30.0, mp4.MJPEG)
    for capture in (card, cpu):
        got = (capture.width, capture.height, capture.frame_count, capture.fps, capture.codec)
        if got != expected:
            raise AssertionError(f"[video] the Motion JPEG clip reads as {got}, not {expected}")
    for index in (0, VIDEO_FRAMES - 1):
        if not torch.equal(card.frame(index).cpu(), cpu.frame(index)):
            raise AssertionError(f"[video] the Motion JPEG clip's frame {index} on the card "
                                 f"differs from the CPU's")
    track = card.track
    with open(clip, "rb") as f:
        f.seek(int(track.offsets[0]))
        sample = f.read(int(track.sizes[0]))
    decode_ms = host_ms(lambda: mjpeg.decode_sample(sample, PHONE_H), reps=5)
    planes = [torch.from_numpy(np.ascontiguousarray(p)).to(device)
              for p in mjpeg.decode_sample(sample, PHONE_H)]
    convert_ms, kernels = device_profile(lambda: color.planes_to_bgr(planes, True), reps=10,
                                         warmup=2)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in card.frames():
        pass
    torch.cuda.synchronize()
    loop_ms = 1e3 * (time.perf_counter() - start) / VIDEO_FRAMES
    result = dict(write_s=write_s, bytes=os.path.getsize(clip), decode_ms=decode_ms,
                  conversion_ms=convert_ms, conversion_kernels=kernels,
                  frames_loop_ms=loop_ms)
    log(f"[video] Motion JPEG phone clip: {VIDEO_FRAMES} frames {PHONE_W}x{PHONE_H} 4:2:0 "
        f"q{PHONE_JPEG_QUALITY} (mp4v / 0x6C, {result['bytes']} B, written in {write_s:.1f} "
        f"s); size, count and rate as written; frames 0 and {VIDEO_FRAMES - 1} on the card "
        f"equal the CPU's; host decode {decode_ms:.3f} ms a frame (native, simple IDCT); "
        f"the card's conversion {convert_ms:.6f} ms device in {kernels} kernels; a frames() "
        f"loop on the card {loop_ms:.3f} ms a frame")
    return result


def wall_flow(poses: np.ndarray, K: np.ndarray, index: int, ref: int, us: np.ndarray,
              vs: np.ndarray) -> np.ndarray:
    """Where the wall's points seen at pixels (us, vs) of frame ``index``
    lie in frame ``ref``, less (us, vs): (..., 2) pixels."""
    from hive_tpu_torch.geometric import pose_vec2mat

    M, M_prev = pose_vec2mat(poses[index]), pose_vec2mat(poses[ref])
    R, t = M[:3, :3], M[:3, 3]
    rays = np.stack([(us - K[0, 2]) / K[0, 0], (vs - K[1, 2]) / K[1, 1], np.ones_like(us)], -1)
    origin, world = -R.T @ t, rays @ R
    points = origin + ((WALL_Z_M - origin[2]) / world[..., 2])[..., None] * world
    seen = points @ M_prev[:3, :3].T + M_prev[:3, 3]
    u_prev = K[0, 0] * seen[..., 0] / seen[..., 2] + K[0, 2]
    v_prev = K[1, 1] * seen[..., 1] / seen[..., 2] + K[1, 2]
    return np.stack([u_prev - us, v_prev - vs], -1)


def wall_motion(poses: np.ndarray, K: np.ndarray, index: int, width: int,
                height: int) -> np.ndarray:
    """The wall's motion into frame ``index`` from the frame before, at the
    centre of each 8x8 luma block: (mbh, mbw, 4, 2) half-pel vectors that
    point into the previous frame, blocks in MPEG-4's order (top-left,
    top-right, bottom-left, bottom-right)."""
    mbw, mbh = -(-width // 16), -(-height // 16)
    vs, us = np.mgrid[0:2 * mbh, 0:2 * mbw].astype(np.float64) * 8 + 3.5
    field = np.rint(2 * wall_flow(poses, K, index, index - 1, us, vs)).astype(np.int32)
    return field.reshape(mbh, 2, mbw, 2, 2).transpose(0, 2, 1, 3, 4).reshape(mbh, mbw, 4, 2)


def wall_motion_qpel(poses: np.ndarray, K: np.ndarray, index: int, ref: int, width: int,
                     height: int) -> np.ndarray:
    """The wall's motion into frame ``index`` from frame ``ref`` at each
    macroblock's centre: (mbh, mbw, 2) quarter-sample vectors (H.264's)
    that point into frame ``ref``."""
    mbw, mbh = -(-width // 16), -(-height // 16)
    vs, us = np.mgrid[0:mbh, 0:mbw].astype(np.float64) * 16 + 7.5
    return np.rint(4 * wall_flow(poses, K, index, ref, us, vs)).astype(np.int32)


_PHONE_RENDERS: list = []


def phone_renders() -> Tuple[list, np.ndarray, np.ndarray]:
    """The phone clip's VIDEO_FRAMES 1920x1080 wall renders as (Y, U, V)
    planes (rendered once, on host threads), its poses and intrinsics."""
    from concurrent.futures import ThreadPoolExecutor

    from hive_tpu_torch.video import color

    texture, K = wall_texture(), wall_camera() * np.array([[3.0], [3.0], [1.0]])
    poses = wall_trajectory(VIDEO_FRAMES)
    if not _PHONE_RENDERS:
        def planes(i):
            return color.rgb_to_yuv420(render_wall(texture, poses[i], K, PHONE_W, PHONE_H)[0])

        with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
            _PHONE_RENDERS.extend(pool.map(planes, range(VIDEO_FRAMES)))
    return _PHONE_RENDERS, poses, K


def write_mpeg4_phone_clip(path: str) -> Tuple[float, dict, list]:
    """The phone clip as MPEG-4 Part 2 Simple Profile (``write_mpeg4_mp4``):
    the same VIDEO_FRAMES 1920x1080 wall renders as the Motion JPEG clip
    (``phone_renders``), an I-VOP every PHONE_MPEG4_GOP frames, the wall's
    motion as the motion field, 4MV on every other macroblock, a video
    packet every row. Returns the seconds it took, the writer's counts and
    the rendered (Y, U, V) planes it coded."""
    from hive_tpu_torch.video import mpeg4

    start = time.perf_counter()
    frames, poses, K = phone_renders()
    mbw, mbh = -(-PHONE_W // 16), -(-PHONE_H // 16)
    four_mv = np.zeros((mbh, mbw), bool)
    four_mv[:, ::2] = True
    totals = mpeg4.write_mpeg4_mp4(
        path, frames, qscale=PHONE_MPEG4_QSCALE, gop=PHONE_MPEG4_GOP,
        motion=lambda i: wall_motion(poses, K, i, PHONE_W, PHONE_H), four_mv=four_mv,
        resync_every=PHONE_MPEG4_RESYNC)
    return time.perf_counter() - start, totals, frames


def write_h264_phone_clip(path: str) -> Tuple[float, dict, list]:
    """The phone clip as H.264 (``write_h264_mp4``, ``MotionPlanner``): the
    same renders, an IDR picture every PHONE_H264_GOP frames (I_NxN with
    seeded 4x4 modes, I_16x16 on every fifth macroblock), P pictures of
    16x16 partitions with the wall's motion to each of up to
    PHONE_H264_REFS references, a slice a row, deblocking on. Returns the
    seconds it took, the writer's counts and the rendered planes."""
    from hive_tpu_torch.video import h264

    start = time.perf_counter()
    frames, poses, K = phone_renders()
    totals = h264.write_h264_mp4(
        path, frames,
        h264.MotionPlanner(PHONE_W, PHONE_H,
                           lambda i, r: wall_motion_qpel(poses, K, i, r, PHONE_W, PHONE_H),
                           gop=PHONE_H264_GOP, qp=PHONE_H264_QP, refs=PHONE_H264_REFS),
        init_qp=PHONE_H264_QP, num_ref_frames=PHONE_H264_REFS, restriction=0)
    totals.pop("coverage")
    return time.perf_counter() - start, totals, frames


def write_h264_b_phone_clip(path: str) -> Tuple[float, dict, list]:
    """The phone clip as x264 codes it at its defaults
    (``write_h264_mp4``, ``MotionPlanner`` with B pictures): the same
    renders, High profile, CABAC, the 8x8 transform, an IDR picture every
    PHONE_H264_GOP frames, PHONE_H264_BFRAMES B pictures between anchors in
    a pyramid (B_Bi_16x16 with the wall's motion to both lists' first two
    references, B_Direct_16x16 on every fourth macroblock), spatial direct,
    implicit B weights, explicit P weights, a slice a row, deblocking on,
    max_num_reorder_frames 2. Returns the seconds it took, the writer's
    counts and the rendered planes."""
    from hive_tpu_torch.video import h264

    start = time.perf_counter()
    frames, poses, K = phone_renders()
    totals = h264.write_h264_mp4(
        path, frames,
        h264.MotionPlanner(PHONE_W, PHONE_H,
                           lambda i, r: wall_motion_qpel(poses, K, i, r, PHONE_W, PHONE_H),
                           gop=PHONE_H264_GOP, qp=PHONE_H264_QP, refs=PHONE_H264_REFS,
                           t8x8=True, bframes=PHONE_H264_BFRAMES, pyramid=True,
                           p_weights=True),
        init_qp=PHONE_H264_QP, num_ref_frames=PHONE_H264_REFS, profile=100, cabac=True,
        transform_8x8=True, weighted_pred=True, weighted_bipred=2)
    totals.pop("coverage")
    return time.perf_counter() - start, totals, frames


def check_h264_b_clip(device, clip: str) -> dict:
    """The x264-shaped H.264 phone clip read on the card against the CPU:
    its coding (High profile, CABAC, the 8x8 transform, explicit P and
    implicit B weights, a reorder depth of 2, B pictures, references among
    them), the demuxer's size, count and rate, frames PHONE_H264_B_CHECKED
    equal and their decoded luma at least PHONE_H264_B_MIN_PSNR against the
    renders; the host decode (native) ms of its IDR picture, a P picture,
    a reference B and a non-reference B picture beside the card's name and
    power limit, and a ``frames()`` loop's ms a frame on the card."""
    from hive_tpu_torch.video import h264, h264_bits, mp4
    from hive_tpu_torch.video.capture import VideoCapture

    write_s, totals, rendered = write_h264_b_phone_clip(clip)
    card, cpu = VideoCapture(clip, device=device), VideoCapture(clip, device="cpu")
    sps = h264.parse_sps(h264_bits.unescape(card.sps_units[0]))
    pps = h264.parse_pps(h264_bits.unescape(card.pps_units[0]))
    coding = (sps["profile"], pps["cabac"], pps["transform_8x8"], pps["weighted_pred"],
              pps["weighted_bipred"], card.reorder)
    if coding != (100, 1, 1, 1, 2, 2) or not totals["b_pictures"] or \
            not totals["b_reference_pictures"]:
        raise AssertionError(f"[video] the x264-shaped clip is (profile, CABAC, 8x8, weighted_pred, "
                             f"weighted_bipred_idc, reorder) {coding}, B pictures "
                             f"{totals['b_pictures']} ({totals['b_reference_pictures']} "
                             f"references)")
    expected = (PHONE_W, PHONE_H, VIDEO_FRAMES, 30.0, mp4.H264)
    for capture in (card, cpu):
        got = (capture.width, capture.height, capture.frame_count, capture.fps, capture.codec)
        if got != expected:
            raise AssertionError(f"[video] the x264-shaped clip reads as {got}, not {expected}")
    psnr = {}
    for index in PHONE_H264_B_CHECKED:
        if not torch.equal(card.frame(index).cpu(), cpu.frame(index)):
            raise AssertionError(f"[video] the x264-shaped clip's frame {index} on the card "
                                 f"differs from the CPU's")
        y = next(card.planes(index, index + 1))[0].cpu().numpy()
        psnr[index] = psnr_db(y, rendered[index][0])
        if not psnr[index] >= PHONE_H264_B_MIN_PSNR:
            raise AssertionError(f"[video] the x264-shaped clip's frame {index} decodes "
                                 f"{psnr[index]:.3f} dB PSNR against the luma it was written "
                                 f"from, under {PHONE_H264_B_MIN_PSNR} dB: the decoder is wrong "
                                 f"on this host")
    units, first, ms = h264_decode_ms(card, 4)
    kinds = []
    decoder = h264.H264Decoder(pixels=False)
    decoder.decode(card.sps_units + card.pps_units)
    for unit in units:
        picture = decoder.decode(unit)
        kinds.append(("I" if picture.idr else h264.SLICE_NAMES[picture.slice_types[0]])
                     + ("" if unit[0][0] >> 5 else " non-reference"))
    if kinds != ["I", "P", "B", "B non-reference"]:
        raise AssertionError(f"[video] the x264-shaped clip's first pictures are {kinds}")
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in card.frames():
        pass
    torch.cuda.synchronize()
    loop_ms = 1e3 * (time.perf_counter() - start) / VIDEO_FRAMES
    names = ("idr", "p", "b_reference", "b_non_reference")
    result = dict(write_s=write_s, bytes=os.path.getsize(clip), writer=totals,
                  luma_psnr_db=psnr, frames_loop_ms=loop_ms,
                  **{f"{name}_bytes": sum(map(len, u)) for name, u in zip(names, units)},
                  **{f"{name}_decode_ms": value for name, value in zip(names, ms)})
    log(f"[video] x264-shaped H.264 phone clip: {VIDEO_FRAMES} frames {PHONE_W}x{PHONE_H}, High "
        f"profile, CABAC, the 8x8 transform, QP {PHONE_H264_QP}, an IDR picture every "
        f"{PHONE_H264_GOP}, {PHONE_H264_BFRAMES} B pictures between anchors in a pyramid, spatial "
        f"direct, implicit B and explicit P weights, max_num_reorder_frames 2 "
        f"({result['bytes']} B, written in {write_s:.1f} s; writer counts {totals}); size, "
        f"count and rate as written; frames {PHONE_H264_B_CHECKED} on the card equal the CPU's, "
        f"their luma at {', '.join(f'{v:.4f}' for v in psnr.values())} dB PSNR against the "
        f"renders (floor {PHONE_H264_B_MIN_PSNR}); host decode "
        + ", ".join(f"{value:.3f} ms the {name.replace('_', ' ')} picture "
                    f"({result[name + '_bytes']} B)" for name, value in zip(names, ms))
        + f" (native, one thread) on {nvidia_smi_line()}; a frames() loop on the card "
        f"{loop_ms:.3f} ms a frame")
    return result


def psnr_db(got: np.ndarray, want: np.ndarray) -> float:
    """PSNR of uint8 ``got`` against ``want``, in dB."""
    error = np.mean((got.astype(np.float64) - want.astype(np.float64)) ** 2)
    return float("inf") if error == 0 else float(10 * np.log10(255.0 ** 2 / error))


def check_mpeg4_clip(device, clip: str) -> dict:
    """The MPEG-4 Part 2 phone clip read on the card against the CPU: the
    demuxer's size, count and rate, frames PHONE_MPEG4_CHECKED equal, and
    their decoded Y planes within PHONE_MPEG4_MIN_PSNR of the renders the
    clip was written from (both captures decode on this host, so this is
    what holds the decoder built here to the picture); the host decode
    (native) ms of the I-VOP and of a P-VOP, the card's 4:2:0 -> BGR
    conversion device ms and kernels, and a ``frames()`` loop's ms a frame
    on the card."""
    from hive_tpu_torch.video import color, mp4, mpeg4
    from hive_tpu_torch.video.capture import VideoCapture

    write_s, totals, rendered = write_mpeg4_phone_clip(clip)
    card, cpu = VideoCapture(clip, device=device), VideoCapture(clip, device="cpu")
    expected = (PHONE_W, PHONE_H, VIDEO_FRAMES, 30.0, mp4.MPEG4)
    for capture in (card, cpu):
        got = (capture.width, capture.height, capture.frame_count, capture.fps, capture.codec)
        if got != expected:
            raise AssertionError(f"[video] the MPEG-4 clip reads as {got}, not {expected}")
    for index in PHONE_MPEG4_CHECKED:
        if not torch.equal(card.frame(index).cpu(), cpu.frame(index)):
            raise AssertionError(f"[video] the MPEG-4 clip's frame {index} on the card "
                                 f"differs from the CPU's")
    psnr = {}
    for index in PHONE_MPEG4_CHECKED:
        y = next(card.planes(index, index + 1))[0].cpu().numpy()
        psnr[index] = psnr_db(y, rendered[index][0])
        if not psnr[index] >= PHONE_MPEG4_MIN_PSNR:
            raise AssertionError(f"[video] the MPEG-4 clip's frame {index} decodes "
                                 f"{psnr[index]:.3f} dB PSNR against the luma it was "
                                 f"written from, under {PHONE_MPEG4_MIN_PSNR} dB: the "
                                 f"decoder is wrong on this host")
    track = card.track
    with open(clip, "rb") as f:
        samples = []
        for k in range(2):
            f.seek(int(track.offsets[k]))
            samples.append(f.read(int(track.sizes[k])))
    decoder = mpeg4.Mpeg4Decoder(track.config)
    i_vop, p_vop = (decoder.check(sample) for sample in samples)
    if (i_vop.coding_type, p_vop.coding_type) != (mpeg4.I_VOP, mpeg4.P_VOP):
        raise AssertionError("[video] the MPEG-4 clip does not start with an I-VOP and a P-VOP")
    i_ms = host_ms(lambda: mpeg4.decode_macroblocks(samples[0], i_vop, decoder.headers, None),
                   reps=5)
    reference = mpeg4.decode_macroblocks(samples[0], i_vop, decoder.headers, None)
    p_ms = host_ms(lambda: mpeg4.decode_macroblocks(samples[1], p_vop, decoder.headers,
                                                    reference), reps=5)
    planes = [torch.from_numpy(np.ascontiguousarray(p)).to(device)
              for p in mpeg4.Mpeg4Decoder(track.config).decode(samples[0])]
    convert_ms, kernels = device_profile(lambda: color.planes_to_bgr(planes, False), reps=10,
                                         warmup=2)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in card.frames():
        pass
    torch.cuda.synchronize()
    loop_ms = 1e3 * (time.perf_counter() - start) / VIDEO_FRAMES
    result = dict(write_s=write_s, bytes=os.path.getsize(clip), writer=totals,
                  luma_psnr_db=psnr, i_vop_bytes=len(samples[0]), p_vop_bytes=len(samples[1]),
                  i_vop_decode_ms=i_ms, p_vop_decode_ms=p_ms, conversion_ms=convert_ms,
                  conversion_kernels=kernels, frames_loop_ms=loop_ms)
    log(f"[video] MPEG-4 Part 2 phone clip: {VIDEO_FRAMES} frames {PHONE_W}x{PHONE_H} "
        f"({16 * -(-PHONE_H // 16)} coded lines), Simple Profile, vop_quant "
        f"{PHONE_MPEG4_QSCALE}, GOP "
        f"{PHONE_MPEG4_GOP}, the wall's motion as 1MV / 4MV vectors, a video packet a row "
        f"(mp4v / 0x20, {result['bytes']} B, written in {write_s:.1f} s; writer counts "
        f"{totals}); size, count and rate as written; frames {PHONE_MPEG4_CHECKED} on the "
        f"card equal the CPU's, their luma at {', '.join(f'{v:.4f}' for v in psnr.values())} "
        f"dB PSNR against the renders (floor {PHONE_MPEG4_MIN_PSNR}); host decode {i_ms:.3f} ms the "
        f"I-VOP ({len(samples[0])} B), "
        f"{p_ms:.3f} ms a P-VOP ({len(samples[1])} B) (native); the card's conversion "
        f"{convert_ms:.6f} ms device in {kernels} kernels; a frames() loop on the card "
        f"{loop_ms:.3f} ms a frame")
    return result


def check_h264_clip(device, clip: str) -> dict:
    """The H.264 phone clip read on the card against the CPU: the demuxer's
    size, count and rate, frames PHONE_H264_CHECKED equal, and their
    decoded Y planes at least PHONE_H264_MIN_PSNR against the renders the
    clip was written from (both captures decode on this host; with the
    exerciser clips' digests, this holds the decoder built here to the
    picture); the capture's open ms, the host decode (native) ms of the IDR
    picture and of a P picture, the card's 4:2:0 -> BGR conversion device
    ms and kernels, and a ``frames()`` loop's ms a frame on the card."""
    from hive_tpu_torch.video import color, mp4
    from hive_tpu_torch.video.capture import VideoCapture

    write_s, totals, rendered = write_h264_phone_clip(clip)
    start = time.perf_counter()
    card = VideoCapture(clip, device=device)
    open_ms = 1e3 * (time.perf_counter() - start)
    cpu = VideoCapture(clip, device="cpu")
    expected = (PHONE_W, PHONE_H, VIDEO_FRAMES, 30.0, mp4.H264)
    for capture in (card, cpu):
        got = (capture.width, capture.height, capture.frame_count, capture.fps, capture.codec)
        if got != expected:
            raise AssertionError(f"[video] the H.264 clip reads as {got}, not {expected}")
    for index in PHONE_H264_CHECKED:
        if not torch.equal(card.frame(index).cpu(), cpu.frame(index)):
            raise AssertionError(f"[video] the H.264 clip's frame {index} on the card "
                                 f"differs from the CPU's")
    psnr = {}
    for index in PHONE_H264_CHECKED:
        y = next(card.planes(index, index + 1))[0].cpu().numpy()
        psnr[index] = psnr_db(y, rendered[index][0])
        if not psnr[index] >= PHONE_H264_MIN_PSNR:
            raise AssertionError(f"[video] the H.264 clip's frame {index} decodes "
                                 f"{psnr[index]:.3f} dB PSNR against the luma it was "
                                 f"written from, under {PHONE_H264_MIN_PSNR} dB: the "
                                 f"decoder is wrong on this host")
    units, first, (idr_ms, p_ms) = h264_decode_ms(card)
    if first is None or not first.idr:
        raise AssertionError("[video] the H.264 clip does not start with an IDR picture")
    planes = [torch.from_numpy(np.ascontiguousarray(p)).to(device)
              for p in (first.y, first.u, first.v)]
    convert_ms, kernels = device_profile(lambda: color.planes_to_bgr(planes, False), reps=10,
                                         warmup=2)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in card.frames():
        pass
    torch.cuda.synchronize()
    loop_ms = 1e3 * (time.perf_counter() - start) / VIDEO_FRAMES
    result = dict(write_s=write_s, bytes=os.path.getsize(clip), writer=totals,
                  luma_psnr_db=psnr, idr_bytes=sum(map(len, units[0])),
                  p_bytes=sum(map(len, units[1])), idr_decode_ms=idr_ms, p_decode_ms=p_ms,
                  open_ms=open_ms, conversion_ms=convert_ms, conversion_kernels=kernels,
                  frames_loop_ms=loop_ms)
    log(f"[video] H.264 phone clip: {VIDEO_FRAMES} frames {PHONE_W}x{PHONE_H} "
        f"({16 * -(-PHONE_H // 16)} coded lines), CAVLC, QP {PHONE_H264_QP}, an IDR picture every "
        f"{PHONE_H264_GOP}, up to {PHONE_H264_REFS} references, the wall's motion as 16x16 "
        f"vectors, a slice a row, deblocking on ({result['bytes']} B, written in {write_s:.1f} "
        f"s; writer counts {totals}); size, count and rate as written; frames "
        f"{PHONE_H264_CHECKED} on the card equal the CPU's, their luma at "
        f"{', '.join(f'{v:.4f}' for v in psnr.values())} dB PSNR against the renders (floor "
        f"{PHONE_H264_MIN_PSNR}); host decode {idr_ms:.3f} ms the IDR picture "
        f"({result['idr_bytes']} B), {p_ms:.3f} ms a P picture ({result['p_bytes']} B) "
        f"(native, one thread); opening the capture (every sample's headers read) "
        f"{open_ms:.3f} ms; the card's conversion {convert_ms:.6f} ms device in {kernels} "
        f"kernels; a frames() loop on the card {loop_ms:.3f} ms a frame")
    return result


def write_hevc_phone_clip(path: str) -> Tuple[float, dict, list]:
    """The phone clip as x265 codes one at its medium preset
    (``write_hevc_mp4``, ``InterPlanner``): the first PHONE_HEVC_FRAMES
    renders, CTB 64, P anchors every 5 pictures from up to three before
    them, a pyramid of four B pictures between them, a CRA picture at 10
    (open GOP: pictures 6-9 its RASL pictures), weightp tables, TMVP,
    MaxNumMergeCand 3, SAO and sign hiding, QP PHONE_HEVC_QP (B pictures 2
    more), PHONE_HEVC_SLICES slices a picture; inter units of 16x16, merged
    or searched to the nearest prediction. Returns the seconds it took, the
    writer's counts and the rendered planes."""
    from hive_tpu_torch.video import hevc

    start = time.perf_counter()
    frames = phone_renders()[0][:PHONE_HEVC_FRAMES]
    totals = hevc.write_hevc_mp4(
        path, frames, hevc.InterPlanner(PHONE_W, PHONE_H, qp=PHONE_HEVC_QP,
                                        slices=PHONE_HEVC_SLICES, cra_every=10),
        ctb_log2=6, max_tb_log2=5, max_depth_intra=1, max_depth_inter=1, sign_hiding=True,
        temporal_mvp=True, weighted_pred=True, num_ref_default=(3, 1), init_qp=PHONE_HEVC_QP)
    totals.pop("contexts")
    return time.perf_counter() - start, {k: v for k, v in totals.items() if v}, frames


def hevc_decode_ms(capture, count: int = 4) -> list:
    """The host decode (native, one thread) ms of an HEVC capture's first
    ``count`` samples in decode order (in x265's layout an IDR picture, a P
    picture, a reference and a non-reference B picture), each given the
    pictures before it, best of 3; and their NAL units."""
    import copy

    from hive_tpu_torch.video import hevc

    units = [capture._nal_units(k) for k in range(count)]
    decoder = hevc.HevcDecoder()
    decoder.decode(capture.parameter_sets)
    ms = []
    for unit in units:
        def decode_one(before=decoder, unit=unit):
            trial = copy.copy(before)
            trial.dpb = list(before.dpb)
            return trial.decode(unit)

        ms.append(host_ms(decode_one, reps=3))
        decoder.decode(unit)
    return units, ms


def check_hevc_clip(device, clip: str) -> dict:
    """The HEVC phone clip read on the card against the CPU: the demuxer's
    size, count and rate, the file and every frame the card reads hashed to
    PHONE_HEVC_DIGESTS, frames PHONE_HEVC_CHECKED equal, and their decoded
    Y planes at least PHONE_HEVC_MIN_PSNR against the renders; the capture's
    open ms, the host decode (native, one thread) ms of its IDR, a P, a
    reference B and a non-reference B picture, and a ``frames()`` loop's ms
    a frame on the card."""
    from hive_tpu_torch.video import mp4
    from hive_tpu_torch.video.capture import VideoCapture

    write_s, totals, rendered = write_hevc_phone_clip(clip)
    start = time.perf_counter()
    card = VideoCapture(clip, device=device)
    open_ms = 1e3 * (time.perf_counter() - start)
    cpu = VideoCapture(clip, device="cpu")
    expected = (PHONE_W, PHONE_H, PHONE_HEVC_FRAMES, 30.0, mp4.HEVC)
    for capture in (card, cpu):
        got = (capture.width, capture.height, capture.frame_count, capture.fps, capture.codec)
        if got != expected:
            raise AssertionError(f"[video] the HEVC clip reads as {got}, not {expected}")
    psnr = {}
    for index in PHONE_HEVC_CHECKED:
        if not torch.equal(card.frame(index).cpu(), cpu.frame(index)):
            raise AssertionError(f"[video] the HEVC clip's frame {index} on the card differs "
                                 f"from the CPU's")
        y = next(card.planes(index, index + 1))[0].cpu().numpy()
        psnr[index] = psnr_db(y, rendered[index][0])
        if not psnr[index] >= PHONE_HEVC_MIN_PSNR:
            raise AssertionError(f"[video] the HEVC clip's frame {index} decodes "
                                 f"{psnr[index]:.4f} dB PSNR against the luma it was written "
                                 f"from, under {PHONE_HEVC_MIN_PSNR} dB: the decoder is wrong "
                                 f"on this host")
    units, ms = hevc_decode_ms(card)
    torch.cuda.synchronize()
    start = time.perf_counter()
    frames = list(card.frames())
    torch.cuda.synchronize()
    loop_ms = 1e3 * (time.perf_counter() - start) / PHONE_HEVC_FRAMES
    digests = (file_digest(clip), frames_digest(frames))
    if digests != PHONE_HEVC_DIGESTS:
        raise AssertionError(f"[video] the HEVC clip's file and frames on the card hash to "
                             f"{digests}, not cv2's {PHONE_HEVC_DIGESTS}")
    kinds = ("idr", "p", "b_reference", "b")
    result = dict(write_s=write_s, bytes=os.path.getsize(clip), writer=totals,
                  digests=digests, luma_psnr_db=psnr,
                  picture_bytes=dict(zip(kinds, (sum(map(len, u)) for u in units))),
                  decode_ms=dict(zip(kinds, ms)), open_ms=open_ms, frames_loop_ms=loop_ms)
    decodes = ", ".join(f"{k} {v:.3f} ms ({result['picture_bytes'][k]} B)"
                        for k, v in zip(kinds, ms))
    log(f"[video] HEVC phone clip: {PHONE_HEVC_FRAMES} frames {PHONE_W}x{PHONE_H} as x265's "
        f"medium preset codes them (CTB 64, P anchors every 5, a B pyramid of 4, an open-GOP "
        f"CRA at 10, weightp, TMVP, MaxNumMergeCand 3), QP {PHONE_HEVC_QP}, SAO and "
        f"deblocking on, {PHONE_HEVC_SLICES} slices a picture ({result['bytes']} B, written in "
        f"{write_s:.1f} s; writer counts {totals}); size, count and rate as written; the file "
        f"and the card's {PHONE_HEVC_FRAMES} frames hash to cv2's {digests}; frames "
        f"{PHONE_HEVC_CHECKED} on the card equal the CPU's, their luma at "
        f"{', '.join(f'{v:.4f}' for v in psnr.values())} dB PSNR against the renders (floor "
        f"{PHONE_HEVC_MIN_PSNR}); host decode (native, one thread) {decodes}; opening the capture (every sample's headers read) {open_ms:.3f} ms; a frames() loop "
        f"on the card {loop_ms:.3f} ms a frame")
    return result


def h264_decode_ms(capture, count: int = 2) -> tuple:
    """The host decode (native, one thread) of an H.264 capture's first
    ``count`` samples in decode order (an IDR picture, then a P picture, and
    in x264's layout a reference and a non-reference B picture): their NAL
    units, the decoded IDR picture, and the ms of each given the pictures
    before it, best of 3."""
    import copy

    from hive_tpu_torch.video import h264

    units = [capture._nal_units(k) for k in range(count)]
    decoder = h264.H264Decoder()
    decoder.decode(capture.sps_units + capture.pps_units)
    first, ms = None, []
    for unit in units:
        def decode_one(before=decoder, unit=unit):
            trial = copy.copy(before)
            trial.refs = list(before.refs)
            return trial.decode(unit)

        ms.append(host_ms(decode_one, reps=3))
        picture = decoder.decode(unit)
        first = first or picture
    return units, first, ms


def run_video_conversions(device, launches, folder: str, runs) -> dict:
    """The user's video runs, each through ``python -m hive_tpu_torch`` in
    this process: the Motion JPEG, MPEG-4 Part 2, H.264 and HEVC phone clips with
    ``--estimate_pose --estimate_depth`` (PnP odometry, its SIFT histograms
    in the ordered kernel; DPT with the check weights, as phase 8 writes
    them) on their first PHONE_CLI_FRAMES frames, and the Stray Scanner
    capture (H.264) with its own poses on all of them: two classifications
    and one band update a fused frame, ``fg.glb``, ``bg.glb`` and
    ``metadata.json`` written, both meshes finite, the frames equal to the
    CPU path's."""
    from hive_tpu_torch.dataset_adaptors import VideoAdaptorBase
    from hive_tpu_torch.image_processing import ROTATE_90_CLOCKWISE
    from hive_tpu_torch.io import HiveDataset

    weights = os.path.join(folder, "weights")
    os.makedirs(weights)
    write_dpt_weights(weights)
    results = {}
    for name, source, extra, size, frames in runs:
        out = os.path.join(folder, f"{name}_converted")
        # Every frame a key frame, as in the other CLI runs: the clip's camera
        # moves 1 cm a frame, which the default threshold fuses once.
        argv = ["hive_tpu_torch", "--dataset_path", source, "--output_path", out, *extra,
                "--num_frames", str(frames), "--key_frame_threshold", "1.0",
                "--webxr_path", out + "_webxr", "--log_file", out + ".log"]
        reset_launch_counts()
        start = time.perf_counter()
        # The bg.glb quantize (17-24 s a run on an H100's host) is left out
        # for the script's time limit: the TUM and [research] runs keep it.
        with mock.patch.dict(os.environ, {"WEIGHTS_PATH": weights}), \
                mock.patch.object(sys, "argv", argv), recording_ordered_hist_shapes([]) as shapes, \
                without_bg_quantize():
            runpy.run_module("hive_tpu_torch", run_name="__main__", alter_sys=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        launches[f"video_{name}"] = main_launch_counts()
        check_launches(f"the {name} CLI run", launches[f"video_{name}"], frames)
        if "--estimate_pose" in extra and launches[f"video_{name}"]["ordered_hist"] == 0:
            raise AssertionError(f"the {name} CLI run's PnP launched no ordered_hist")
        for written in ("mesh/fg.glb", "mesh/bg.glb", "metadata.json"):
            if not os.path.isfile(os.path.join(out, written)):
                raise AssertionError(f"[video] {name}: the run wrote no {written}")
        check_meshes_finite(out)
        dataset = HiveDataset(out)
        first = dataset.rgb_dataset[0]
        if first.shape[:2] != size:
            raise AssertionError(f"[video] {name}: frames of {first.shape[:2]}, not {size}")
        # The frames against the CPU path's: the same file decoded on the host
        # for the CPU, rotated, resized and encoded there.
        cpu_frames = os.path.join(folder, f"{name}_cpu_rgb")
        os.makedirs(cpu_frames)
        VideoAdaptorBase.extract_video(
            os.path.join(source, "rgb.mp4") if name == "stray" else source, cpu_frames,
            frames, target_resolution=size,
            rotation=ROTATE_90_CLOCKWISE if name == "stray" else None, file_extension="jpg",
            device="cpu")
        compared = sorted(os.listdir(cpu_frames))
        if len(compared) != frames:
            raise AssertionError(f"[video] {name}: the CPU path wrote {len(compared)} frames")
        for frame in compared:
            with open(os.path.join(cpu_frames, frame), "rb") as f, \
                    open(os.path.join(out, "rgb", frame), "rb") as g:
                if f.read() != g.read():
                    raise AssertionError(f"[video] {name}: frame {frame} differs from the CPU "
                                         f"path's")
        with open(os.path.join(out, "profiling.json")) as f:
            profiling = json.load(f)
        timing = profiling["timing"]
        stages = {stage: value.get("total") if isinstance(value, dict) else value
                  for stage, value in timing.items() if stage != "stages_overlapped"}
        for part in ("integration", "mesh_extraction"):
            stages[part] = timing.get("background_reconstruction", {}).get(part)
        for part in ("background", "foreground"):
            stages[f"mesh_compression_{part}"] = timing.get("mesh_compression", {}).get(part)
        results[name] = dict(wall_s=wall, per_frame_s=profiling["elapsed_time"]["per_frame"],
                             load_dataset=timing["load_dataset"], stages=stages,
                             peak_bytes=int(torch.cuda.max_memory_allocated(device)),
                             ordered_hist_shapes=shapes)
        log(f"[video] {name}: {frames} frames converted and meshed through the CLI on "
            f"the card in {wall:.1f} s ({results[name]['per_frame_s']} s a frame, "
            f"profiling.json); fg.glb, bg.glb and metadata.json written, meshes finite, the "
            f"{frames} frames' JPEG bytes equal the CPU path's; stages (s) "
            f"{json.dumps(stages)}; load_dataset {json.dumps(timing['load_dataset'])}; launches "
            f"{launches[f'video_{name}']}; ordered_hist calls (rows, entries, bins) {shapes}")
    return results


# ---------------------------------------------------------------------------
# [eval]: the evaluation path and the player.
# ---------------------------------------------------------------------------

# The card's render of a view against the port's CPU render of it: both
# evaluate the same candidate pixels with the same float32 operations (the
# FMAs through float64), so no pixel may differ.
EVAL_EDGE_PIXELS = 0
# batch_ssim_psnr (float32, on the card) against the host's float64 ssim /
# psnr: the CPU tests' tolerances (tests/test_torch_render_metrics.py); a
# CPU run of three VGA pairs read 7.5e-7 and 1.9e-7 dB.
EVAL_SSIM_TOL, EVAL_PSNR_TOL_DB = 1e-5, 1e-4
# LPIPS and MIFD on the card against the CPU, relative: LPIPS's float32
# convs run in other orders; MIFD must be equal (SIFT's histograms sum in
# one order on both, its descriptor norms in one order, the distances'
# mean on the host).
EVAL_LPIPS_RTOL, EVAL_MIFD_RTOL = 1e-4, 0.0
# The rendered background's depth against the input depth maps, median over
# the pixels where both are valid and no object is masked: the export's
# centring offset is estimated from the depth maps' bounds (export_pose),
# so this is loose; a wrong pose or a broken z-buffer misses it by far more.
EVAL_DEPTH_MEDIAN_M = 0.05
# Frames scored against the input frames.
EVAL_SCORED = (10, 20, 29)
# The LLFF folder: fern's images_8 size and count.
LLFF_W, LLFF_H, LLFF_VIEWS, LLFF_FACTOR = 504, 378, 20, 8
# The 180-degree z rotation the export applies (Pipeline._center_scenes).
UPRIGHT = np.diag([-1.0, -1.0, 1.0])


def decoder_libraries() -> dict:
    """What ``ctypes.util.find_library`` finds for the libraries a video
    decoder could use (FFmpeg's and NVIDIA's NVDEC): the next step of the
    video inputs depends on it. Logs only."""
    import ctypes.util

    return {name: ctypes.util.find_library(name)
            for name in ("avcodec", "avformat", "avutil", "swscale", "nvcuvid")}


def export_offset(dataset, stride: int = 4) -> np.ndarray:
    """The translation the export adds after turning the scene upright:
    minus the x centre and the y and z minima of the upright scene's bounds,
    estimated from the valid depth of every frame back-projected with the
    ground-truth poses (the meshes themselves were not kept uncentred)."""
    K_inv = np.linalg.inv(dataset.camera_matrix.astype(np.float64))
    poses = dataset.camera_trajectory.to_homogenous_transforms()
    lo, hi = np.full(3, np.inf), np.full(3, -np.inf)
    for i in range(dataset.num_frames):
        depth = np.asarray(dataset.depth_dataset[i], np.float64)[::stride, ::stride]
        v, u = np.nonzero(depth > 0)
        rays = K_inv @ np.stack([u * stride, v * stride, np.ones_like(u)]).astype(np.float64)
        cam = rays * depth[v, u]
        world = poses[i, :3, :3].T @ (cam - poses[i, :3, 3:4])
        upright = UPRIGHT @ world
        lo, hi = np.minimum(lo, upright.min(axis=1)), np.maximum(hi, upright.max(axis=1))
    return -np.array([(lo[0] + hi[0]) / 2, lo[1], lo[2]])


def export_pose(pose: np.ndarray, offset: np.ndarray):
    """(R, t) of a world-to-camera pose for the exported (upright, centred)
    scene: p_export = U p_world + offset."""
    R, t = pose[:3, :3], pose[:3, 3:4]
    return R @ UPRIGHT, t - R @ UPRIGHT @ offset.reshape(3, 1)


def view_scene(background, foreground, frame: int):
    from hive_tpu_torch.meshing.mesh import Scene

    scene = Scene()
    for name, mesh in background.geometry.items():
        scene.add_geometry(mesh, node_name=f"bg_{name}")
    if f"{frame:06d}" in foreground.geometry:
        scene.add_geometry(foreground.geometry[f"{frame:06d}"], node_name=f"{frame:06d}")
    return scene


def time_view(fn, device) -> dict:
    """One view's device ms and kernels (profiler), launch loop (events)
    and peak device memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device)
    ms, ops = device_profile(fn, reps=2, warmup=0)
    return dict(ms=ms, kernels=ops, loop_ms=events_ms(fn, reps=2, warmup=0), peak_bytes=peak)


def write_llff_folder(base: str, dataset, offset: np.ndarray) -> None:
    """An LLFF capture at fern's images_8 size: LLFF_VIEWS centre crops of
    the converted frames as JPEGs (the port's encoder, Pillow's bytes) in
    ``images_8/`` and ``poses_bounds.npy`` with the full-size h, w, f and
    the ground-truth poses expressed in the exported scene's frame, LLFF's
    [down, right, back] axes."""
    from hive_tpu_torch.image_codecs import write_image

    folder = os.path.join(base, f"images_{LLFF_FACTOR}")
    os.makedirs(folder)
    K = dataset.camera_matrix
    # The crop whose centre is nearest the principal point.
    x0 = int(round(K[0, 2] - LLFF_W / 2))
    y0 = int(round(K[1, 2] - LLFF_H / 2))
    poses = dataset.camera_trajectory.to_homogenous_transforms()
    rows = []
    for i in range(LLFF_VIEWS):
        frame = dataset.rgb_dataset[i][y0:y0 + LLFF_H, x0:x0 + LLFF_W]
        write_image(os.path.join(folder, f"image{i:03d}.jpg"), frame)
        R, t = export_pose(poses[i], offset)
        c2w_R, c2w_t = R.T, -R.T @ t
        pose = np.zeros((3, 5))
        pose[:, :3] = np.stack([c2w_R[:, 1], c2w_R[:, 0], -c2w_R[:, 2]], axis=-1)
        pose[:, 3] = c2w_t[:, 0]
        pose[:, 4] = [LLFF_H * LLFF_FACTOR, LLFF_W * LLFF_FACTOR, K[0, 0] * LLFF_FACTOR]
        rows.append(np.concatenate([pose.reshape(-1), [0.5, 5.0]]))
    np.save(os.path.join(base, "poses_bounds.npy"), np.stack(rows))


def fetch(port: int, path: str, headers: dict):
    import http.client

    conn = http.client.HTTPConnection("localhost", port, timeout=60)
    try:
        conn.request("GET", path, headers=headers)
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def check_viewer(webxr: str, name: str) -> dict:
    """The player's server on a free local port: the page and an exported
    ``bg.glb``, plain and gzip-encoded, byte for byte."""
    import gzip
    import threading

    from hive_tpu_torch import viewer

    server = viewer.make_server(webxr, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    try:
        status, _, page = fetch(port, f"/?video={name}", {})
        if status != 200 or page != viewer.VIEWER_HTML.read_bytes():
            raise AssertionError(f"the viewer's page: status {status}, {len(page)} bytes")
        bg = open(os.path.join(webxr, name, "bg.glb"), "rb").read()
        status, headers, plain = fetch(port, f"/{name}/bg.glb", {})
        if status != 200 or plain != bg or "Content-Encoding" in headers:
            raise AssertionError(f"bg.glb without gzip: status {status}, {len(plain)} bytes")
        status, headers, packed = fetch(port, f"/{name}/bg.glb", {"Accept-Encoding": "gzip"})
        if (status != 200 or headers.get("Content-Encoding") != "gzip"
                or gzip.decompress(packed) != bg):
            raise AssertionError(f"bg.glb with gzip: status {status}, headers {headers}")
        missing, _, _ = fetch(port, f"/{name}/missing.glb", {})
        if missing != 404:
            raise AssertionError(f"a missing file gave {missing}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
    return dict(port=port, page_bytes=len(page), bg_bytes=len(bg), bg_gzip_bytes=len(packed))


def check_eval(device, tmp: str, e2e: str) -> dict:
    """[eval]: the evaluation path and the player on phase 7's export.
    Renders ``bg.glb`` with each frame's ``fg.glb`` node from the 30
    ground-truth poses at 640x480 on the card (one view also on the CPU,
    equal), scores three frames against the input frames (``batch_ssim_psnr``
    on the card against the host's ``ssim`` / ``psnr``; LPIPS with check
    weights and MIFD, card against CPU; MIFD also on two frames of phase
    16's textured wall), renders one view of phase 6's e2e
    ``bg.glb``, writes an LLFF folder at fern's factor-8 size and runs
    ``evaluate_renders`` on its held-out views, then serves the export with
    the viewer."""
    from hive_tpu_torch import metrics
    from hive_tpu_torch.data import llff
    from hive_tpu_torch.io import HiveDataset, load_image
    from hive_tpu_torch.meshing.gltf import load_glb
    from hive_tpu_torch.meshing.render import render_scene_counted
    from hive_tpu_torch.models import lpips as lpips_model

    phase_start = time.perf_counter()
    out = os.path.join(tmp, "converted")
    dataset = HiveDataset(out)
    K, width, height = dataset.camera_matrix, dataset.frame_width, dataset.frame_height
    background = load_glb(os.path.join(out, "mesh", "bg.glb"))
    foreground = load_glb(os.path.join(out, "mesh", "fg.glb"))
    offset = export_offset(dataset)
    poses = dataset.camera_trajectory.to_homogenous_transforms()

    def render(frame, on=device):
        R, t = export_pose(poses[frame], offset)
        return render_scene_counted(view_scene(background, foreground, frame), K, R, t, width,
                                    height, device=on)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    start = time.perf_counter()
    views = [render(i) for i in range(dataset.num_frames)]
    torch.cuda.synchronize()
    views_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated(device)
    coverage = [float((depth > 0).mean()) for _, depth, _ in views]
    if min(coverage) < 0.9:
        raise AssertionError(f"the views cover {min(coverage):.3f} of the frame at least")
    residuals = []
    for i, (_, depth, _) in enumerate(views):
        measured = np.asarray(dataset.depth_dataset[i], np.float64)
        valid = (depth > 0) & (measured > 0) & (np.asarray(dataset.mask_dataset[i]) == 0)
        residuals.append(float(np.median(np.abs(depth[valid] - measured[valid]))))
    if max(residuals) > EVAL_DEPTH_MEDIAN_M:
        raise AssertionError(f"rendered depth misses the input depth by a median of "
                             f"{max(residuals):.4f} m (bound {EVAL_DEPTH_MEDIAN_M})")
    timed = time_view(lambda: render(15), device)
    view_faces = sum(m.num_faces for m in view_scene(background, foreground, 15).geometry.values())
    start = time.perf_counter()
    cpu_image, cpu_depth, _ = render(15, on="cpu")
    cpu_s = time.perf_counter() - start
    differing = int(((cpu_image != views[15][0]).any(axis=-1) | (cpu_depth != views[15][1])).sum())
    if differing > EVAL_EDGE_PIXELS:
        raise AssertionError(f"the card's view 15 differs from the CPU's at {differing} pixels")
    log(f"[eval] {dataset.num_frames} views of bg.glb + each frame's fg.glb node (view 15: "
        f"{view_faces} faces) "
        f"at {width}x{height} on the card in {views_s:.2f} s ({1e3 * views_s / len(views):.1f} "
        f"ms a view with the host's copies), peak device memory {peak} B; view 15: "
        f"{timed['ms']:.4f} ms device, {timed['kernels']:.0f} kernels, {timed['loop_ms']:.4f} ms "
        f"launch loop, {views[15][2]} candidate pixels (the reference's scan: "
        f"{width * height * view_faces:.3e} pixel-triangle pairs), peak {timed['peak_bytes']} B; "
        f"coverage {min(coverage):.4f}-{max(coverage):.4f}; depth against the input's, median "
        f"|diff| {min(residuals):.5f}-{max(residuals):.5f} m; the CPU's view 15 ({cpu_s:.1f} s) "
        f"differs at {differing} pixels (bound {EVAL_EDGE_PIXELS})")

    # Scores of three frames against the input frames.
    photos = np.stack([dataset.rgb_dataset[i] for i in EVAL_SCORED])
    renders = np.stack([views[i][0] for i in EVAL_SCORED])
    batch_ssim, batch_psnr = metrics.batch_ssim_psnr(photos, renders, device=device)
    host_ssim = np.array([metrics.ssim(p, r) for p, r in zip(photos, renders)])
    host_psnr = np.array([metrics.psnr(p, r) for p, r in zip(photos, renders)])
    ssim_err = float(np.abs(batch_ssim - host_ssim).max())
    psnr_err = float(np.abs(batch_psnr - host_psnr).max())
    if not (ssim_err <= EVAL_SSIM_TOL and psnr_err <= EVAL_PSNR_TOL_DB):
        raise AssertionError(f"batch_ssim_psnr on the card vs the host: SSIM {ssim_err:.3e}, "
                             f"PSNR {psnr_err:.3e} dB")
    batch_ms, batch_ops = device_profile(
        lambda: metrics.batch_ssim_psnr(photos, renders, device=device), reps=3, warmup=1)

    weights = os.path.join(tmp, "eval_weights")
    os.makedirs(weights)
    np.savez(os.path.join(weights, lpips_model.WEIGHTS_FILENAME),
             **lpips_model.check_params(SEED))
    with mock.patch.dict(os.environ, {"WEIGHTS_PATH": weights}), \
            mock.patch.dict(metrics._lpips_models, clear=True):
        lpips_card = [metrics.lpips(p, r, device=device) for p, r in zip(photos, renders)]
        lpips_ms, lpips_ops = device_profile(
            lambda: metrics.lpips(photos[0], renders[0], device=device), reps=3, warmup=1)
        lpips_cpu = [metrics.lpips(p, r, device="cpu") for p, r in zip(photos, renders)]
        # MIFD of the scored frames (the striped wall gives SIFT few
        # matches: NaN where none passes the ratio test, on either device),
        # and of two VGA frames of phase 16's textured wall 1 cm apart.
        wall = os.path.join(tmp, "tum_wall", "rgb")
        wall_pair = [load_image(os.path.join(wall, name)) for name in sorted(os.listdir(wall))[:2]]
        pairs = list(zip(photos, renders)) + [tuple(wall_pair)]
        mifd_card = [metrics.mifd(a, b, device=device) for a, b in pairs]
        mifd_ms, mifd_ops = device_profile(lambda: metrics.mifd(*wall_pair, device=device),
                                           reps=1, warmup=0)
        mifd_cpu = [metrics.mifd(*pairs[i], device="cpu") for i in (0, len(pairs) - 1)]
        mifd_err = 0.0
        for card, cpu in zip((mifd_card[0], mifd_card[-1]), mifd_cpu):
            if np.isnan(card) != np.isnan(cpu):
                raise AssertionError(f"MIFD on the card {mifd_card} vs the CPU's {mifd_cpu}")
            if not np.isnan(cpu):
                mifd_err = max(mifd_err, abs(card - cpu) / abs(cpu))
        lpips_err = max(abs(c - h) / abs(h) for c, h in zip(lpips_card, lpips_cpu))
        if not (np.isfinite(lpips_card).all() and lpips_err <= EVAL_LPIPS_RTOL):
            raise AssertionError(f"LPIPS on the card {lpips_card} vs the CPU {lpips_cpu}")
        if not (np.isfinite(mifd_card[-1]) and mifd_err <= EVAL_MIFD_RTOL):
            raise AssertionError(f"MIFD on the card {mifd_card} vs the CPU's {mifd_cpu}")
        log(f"[eval] frames {list(EVAL_SCORED)} against the input frames: SSIM "
            f"{np.round(batch_ssim, 4).tolist()}, PSNR {np.round(batch_psnr, 3).tolist()} dB "
            f"(batch_ssim_psnr {batch_ms:.4f} ms device, {batch_ops:.0f} kernels; the host's "
            f"within {ssim_err:.2e} / {psnr_err:.2e} dB); LPIPS (check weights) "
            f"{np.round(lpips_card, 4).tolist()} ({lpips_ms:.4f} ms device a pair, "
            f"{lpips_ops:.0f} kernels; the CPU's within {lpips_err:.2e} relative); MIFD "
            f"{np.round(mifd_card[:-1], 3).tolist()} px, the wall pair {mifd_card[-1]:.3f} px "
            f"({mifd_ms:.4f} ms device, {mifd_ops:.0f} kernels; the CPU's "
            f"{np.round(mifd_cpu, 3).tolist()} for the first and the wall pair, "
            f"{mifd_err:.2e} relative)")

        # evaluate_renders on an LLFF capture of the same scene.
        capture = os.path.join(tmp, "llff_fern_8")
        write_llff_folder(capture, dataset, offset)
        loaded = llff.LLFFDataset(capture, factor=LLFF_FACTOR)
        if (loaded.num_images, int(loaded.hwf[0]), int(loaded.hwf[1])) != (LLFF_VIEWS, LLFF_H,
                                                                           LLFF_W):
            raise AssertionError(f"the LLFF folder loads as {loaded.num_images} x {loaded.hwf}")
        _, held_out = loaded.train_test_split()
        start = time.perf_counter()
        scores = llff.evaluate_renders(background, loaded, held_out,
                                       output_folder=os.path.join(tmp, "llff_renders"),
                                       device=device)
        llff_s = time.perf_counter() - start
    # The striped wall leaves MIFD without matches (labelled, as on the
    # scored frames); the other metrics must be finite.
    if (set(scores.get("skipped", {})) - {"mifd"}
            or not all(np.isfinite(scores["mean"][k]) for k in ("ssim", "psnr", "lpips"))):
        raise AssertionError(f"evaluate_renders: {scores}")
    log(f"[eval] LLFF folder {LLFF_VIEWS} x {LLFF_W}x{LLFF_H} JPEG views, held out "
        f"{held_out}: evaluate_renders in {llff_s:.2f} s, means "
        + ", ".join(f"{k} {v:.4f}" for k, v in scores["mean"].items())
        + f"; skipped {scores.get('skipped', {})}")

    # One view of the e2e run's bg.glb.
    start = time.perf_counter()
    e2e_scene = load_glb(os.path.join(e2e, "mesh", "bg.glb"))
    load_s = time.perf_counter() - start
    e2e_data = HiveDataset(e2e)
    e2e_mesh = next(iter(e2e_scene.geometry.values()))
    e2e_R, e2e_t = export_pose(e2e_data.camera_trajectory.to_homogenous_transforms()[0],
                               export_offset(e2e_data))

    def render_e2e():
        return render_scene_counted(e2e_scene, e2e_data.camera_matrix, e2e_R, e2e_t,
                                    e2e_data.frame_width, e2e_data.frame_height, device=device)

    _, e2e_depth, e2e_candidates = render_e2e()
    e2e_timed = time_view(render_e2e, device)
    e2e_cover = float((e2e_depth > 0).mean())
    if e2e_cover < 0.5:
        raise AssertionError(f"the e2e view covers {e2e_cover:.3f} of the frame")
    log(f"[eval] one view of the e2e bg.glb ({e2e_mesh.num_vertices} vertices, "
        f"{e2e_mesh.num_faces} faces; load_glb {load_s:.1f} s) at "
        f"{e2e_data.frame_width}x{e2e_data.frame_height}: {e2e_timed['ms']:.4f} ms device, "
        f"{e2e_timed['kernels']:.0f} kernels, {e2e_timed['loop_ms']:.4f} ms launch loop, peak "
        f"device memory {e2e_timed['peak_bytes']} B; {e2e_candidates} candidate pixels "
        f"({e2e_candidates / e2e_mesh.num_faces:.2f} a face; the reference's scan: "
        f"{e2e_data.frame_width * e2e_data.frame_height * e2e_mesh.num_faces:.3e}); coverage "
        f"{e2e_cover:.4f}")

    served = check_viewer(os.path.join(tmp, "webxr"), os.path.basename(out))
    log(f"[eval] viewer on localhost:{served['port']}: the page ({served['page_bytes']} B) "
        f"and bg.glb plain ({served['bg_bytes']} B) and gzip-encoded "
        f"({served['bg_gzip_bytes']} B) byte for byte, a missing file 404; the phase took "
        f"{time.perf_counter() - phase_start:.1f} s")
    return dict(views=len(views), views_s=views_s, view=timed, peak_bytes=peak,
                candidates=views[15][2], faces=view_faces, coverage_min=min(coverage),
                depth_median_m=max(residuals), cpu_differing=differing,
                ssim=batch_ssim.tolist(), psnr_db=batch_psnr.tolist(), ssim_err=ssim_err,
                psnr_err_db=psnr_err, batch_ms=batch_ms, lpips=lpips_card, lpips_ms=lpips_ms,
                lpips_err=lpips_err, mifd_px=mifd_card, mifd_ms=mifd_ms, mifd_err=mifd_err,
                llff=scores["mean"], llff_s=llff_s,
                e2e=dict(e2e_timed, candidates=e2e_candidates, faces=e2e_mesh.num_faces,
                         vertices=e2e_mesh.num_vertices, load_s=load_s, coverage=e2e_cover),
                viewer=served)


# ---------------------------------------------------------------------------
# [research]: the experiments harness, the image-pair comparisons and the
# CMU Panoptic loader.
# ---------------------------------------------------------------------------

# The top-left of the panoptic pair (1920x1080) on which compare-pair holds
# the card to the CPU; the card compares the whole pair.
PANOPTIC_CPU_CROP = (540, 960)
# The harness's groups and configs on phase 7's TUM folder.
RESEARCH_GROUPS = ("pipeline", "export", "trajectory", "compression", "mesh_compression",
                   "inpainting")
# The harness's configs run here: ground truth and everything estimated
# (its "cm" config, estimated pose on ground-truth depth, is cut for the
# script's time limit).
RESEARCH_CONFIGS = ("gt", "est")
# The harness's methods, one per group, timed in its run.
RESEARCH_METHODS = ("run_pipeline_experiments", "export_pipeline_results",
                    "run_trajectory_experiments", "run_compression_experiments",
                    "run_mesh_compression_experiments", "run_inpainting_experiments")
# compare_images on the card against the CPU, relative: SSIM and PSNR are
# float64 on both with the same operations (only the means' summation
# orders differ).
COMPARE_SSIM_PSNR_RTOL = 1e-6
# A synthetic Kinoptic capture at the dataset's sizes: 10 Kinect nodes,
# 1920x1080 colour JPEGs, 512x424 uint16 depth, HD frames 1-5 loaded from
# two nodes (each stream drops its first frame, so the frame a search
# selects is neither the HD index nor the stream row).
PANOPTIC_NODES, PANOPTIC_LOADED = 10, (3, 8)
PANOPTIC_HD = range(1, 6)
PANOPTIC_W, PANOPTIC_H = 1920, 1080
# The loaded nodes' cameras: 4 cm apart along x, both 2 m from the wall.
PANOPTIC_BASELINE_M = 0.04


def panoptic_camera() -> np.ndarray:
    """A Kinect v2 colour camera's intrinsics at 1920x1080."""
    return np.array([[1050.0, 0.0, 959.5], [0.0, 1050.0, 539.5], [0.0, 0.0, 1.0]])


def write_panoptic_capture(base: str, size=(PANOPTIC_H, PANOPTIC_W), hd=PANOPTIC_HD,
                           nodes: int = PANOPTIC_NODES, loaded=PANOPTIC_LOADED,
                           seed: int = SEED) -> dict:
    """A CMU Panoptic (Kinoptic) capture named after ``base``'s folder: HD
    sync table, every node's Kinect colour and depth sync streams (each
    drops its frame number 1 and drifts by its own skew), dome and Kinect
    calibrations, each node's colour JPEGs (the ``loaded`` nodes' frames
    render phase 16's textured wall from cameras PANOPTIC_BASELINE_M apart,
    the others copy the first loaded node's bytes) and ``depthdata.dat``
    (the wall at 2 m plus seeded noise, rows mirrored as the sensor stores
    them). Returns, for each loaded node and HD frame, the colour frame
    number and depth row the sync search must select, the rendered frames
    and the depth rows as written."""
    from hive_tpu_torch.geometric import pose_mat2vec
    from hive_tpu_torch.image_codecs import encode_jpeg
    from hive_tpu_torch.utils import tqdm_imap

    rng = np.random.default_rng(seed)
    name = os.path.basename(base)
    height, width = size
    frames = max(hd) + 2
    period, t0 = 1000.0 / 29.97, 1000.0
    hd_times = [t0 + period * k for k in range(frames)]
    with open(os.path.join(base, f"synctables_{name}.json"), "w") as f:
        json.dump({"vga": {"index": list(range(frames)),
                           "univ_time": [t0 + 40.0 * k for k in range(frames)]},
                   "hd": {"index": list(range(frames)), "univ_time": hd_times}}, f)
    numbers = list(range(2, frames + 1))          # frame number 1 dropped
    streams = {"color": {}, "depth": {}}
    for node in range(1, nodes + 1):
        skew = 0.05 * node
        streams["color"][f"KINECTNODE{node}"] = {
            "index": numbers,
            "univ_time": [t0 + period * (n - 1) + 6.25 + skew * (n - 1) for n in numbers]}
        streams["depth"][f"KINECTNODE{node}"] = {
            "index": numbers,
            "univ_time": [t0 + period * (n - 1) + 3.0 + skew * (n - 1) for n in numbers]}
    with open(os.path.join(base, f"ksynctables_{name}.json"), "w") as f:
        json.dump({"kinect": streams}, f)

    K = panoptic_camera()
    cameras, sensors = [], []
    for node in range(1, nodes + 1):
        M_color = np.eye(4)
        M_color[:3, 3] = rng.normal(0, 0.05, 3)
        cameras.append({"name": f"50_{node:02d}", "type": "kinect-color",
                        "resolution": [width, height], "panel": 50, "node": node,
                        "K": K.tolist(), "distCoef": [0.0] * 5, "R": np.eye(3).tolist(),
                        "t": [[-100.0 * PANOPTIC_BASELINE_M * node], [0.0], [0.0]]})
        sensors.append({"K_depth": [[365.0, 0, 255.5], [0, 365.0, 211.5], [0, 0, 1]],
                        "M_depth": np.eye(4).tolist(), "distCoeffs_depth": [0.0] * 5,
                        "depth_width": 512, "depth_height": 424, "K_color": K.tolist(),
                        "M_color": M_color.tolist(), "distCoeffs_color": [0.0] * 5,
                        "color_width": width, "color_height": height,
                        "color_time_offset": 0, "depth_time_offset": 0,
                        "M_world2sensor": np.eye(4).tolist(), "domeCenter": [[0.0]] * 3})
    with open(os.path.join(base, f"calibration_{name}.json"), "w") as f:
        json.dump({"calibDataSource": "synthetic", "cameras": cameras}, f)
    with open(os.path.join(base, f"kcalibration_{name}.json"), "w") as f:
        json.dump({"calibDataSource": "synthetic", "panopticCalibDataSource": "synthetic",
                   "M_world2vga": np.eye(4).tolist(), "sensors": sensors}, f)

    texture = wall_texture(seed)
    views = [(node, n) for node in loaded for n in numbers]

    def render(view):
        node, number = view
        # A camera at x = baseline x node, moving 2 mm a frame.
        pose = np.eye(4)
        pose[0, 3] = -(PANOPTIC_BASELINE_M * node + 0.002 * number)
        rgb, _ = render_wall(texture, pose_mat2vec(pose), K, width, height)
        return rgb, encode_jpeg(rgb, quality=90)

    rendered = dict(zip(views, tqdm_imap(render, views, show_progress=False)))
    depth_rows = (2000 + rng.integers(-30, 30, (len(numbers), 424, 512))).astype("<u2")
    for node in range(1, nodes + 1):
        images = os.path.join(base, "kinectImgs", f"50_{node:02d}")
        depth = os.path.join(base, "kinect_shared_depth", f"KINECTNODE{node}")
        os.makedirs(images)
        os.makedirs(depth)
        source = node if node in loaded else loaded[0]
        for number in numbers:
            with open(os.path.join(images, f"50_{node:02d}_{number:08d}.jpg"), "wb") as f:
                f.write(rendered[source, number][1])
        with open(os.path.join(depth, "depthdata.dat"), "wb") as f:
            f.write(depth_rows[:, :, ::-1].tobytes())
    return {"selected": {(node, k): (k + 1, k - 1) for node in loaded for k in hd},
            "rendered": {view: rgb for view, (rgb, _) in rendered.items()},
            "depth_rows": depth_rows}


def check_panoptic(tmp: str) -> dict:
    """The Kinoptic capture's synced pairs for the loaded nodes and HD
    frames: the colour frame and depth row the sync search must select, the
    depth in metres exactly, the colour within JPEG loss of the render."""
    from hive_tpu_torch.dataset import CMUPanopticDataset
    from hive_tpu_torch.io import load_image

    base = os.path.join(tmp, "kinoptic_synthetic")
    os.makedirs(base)
    start = time.perf_counter()
    written = write_panoptic_capture(base)
    write_s = time.perf_counter() - start
    dataset = CMUPanopticDataset(base)
    pairs, host_ms = {}, []
    for (node, k), (number, row) in written["selected"].items():
        start = time.perf_counter()
        image, depth = dataset.get_synced_frame_data(frame_index=k, kinect_node=node)
        host_ms.append(1e3 * (time.perf_counter() - start))
        if not np.array_equal(image, load_image(dataset.get_image_path(node, number))):
            raise AssertionError(f"node {node}, HD frame {k}: not colour frame {number}")
        # Closest to its own render among the node's frames (2 mm apart).
        losses = {n: float(np.abs(image.astype(np.int16) - rgb).mean())
                  for (v, n), rgb in written["rendered"].items() if v == node}
        if image.shape != (PANOPTIC_H, PANOPTIC_W, 3) or min(losses, key=losses.get) != number:
            raise AssertionError(f"node {node}, HD frame {k}: {image.shape}, mean |difference| "
                                 f"to each frame's render {losses}, want frame {number}'s")
        want = written["depth_rows"][row] * CMUPanopticDataset.depth_to_meters
        if depth.dtype != np.float64 or not np.array_equal(depth, want):
            raise AssertionError(f"node {node}, HD frame {k}: not depth row {row}")
        pairs[node, k] = image
    log(f"[research] panoptic: a {PANOPTIC_NODES}-node Kinoptic capture "
        f"({PANOPTIC_W}x{PANOPTIC_H} JPEGs, 512x424 u16 depth) written in {write_s:.1f} s; "
        f"{len(pairs)} synced pairs of nodes {list(PANOPTIC_LOADED)} x HD frames "
        f"{list(PANOPTIC_HD)} are the frames the sync search must select (colour frame k + 1, "
        f"depth row k - 1); host ms a pair (the {PANOPTIC_W}x{PANOPTIC_H} JPEG decode, native, "
        f"and the depth seek): "
        f"{np.round(host_ms, 2).tolist()}, median {np.median(host_ms):.2f}")
    return {"pairs": pairs, "write_s": write_s, "host_ms": host_ms}


def compare_on_card_and_cpu(name: str, image_a, image_b, device, crop=None) -> dict:
    """compare_images on the card and on the CPU: SSIM and PSNR within
    COMPARE_SSIM_PSNR_RTOL, MIFD equal (NaN on both, or within
    EVAL_MIFD_RTOL, the [eval] phase's card-vs-CPU bound, logged with its
    difference), LPIPS NaN and labelled without weights; each metric's
    device ms and kernels, on the whole images. With ``crop`` (rows,
    columns), the card compares the whole images, and card and CPU are held
    equal on their top-left ``crop`` (the CPU's MIFD at 1080p takes 47 s)."""
    from hive_tpu_torch import metrics
    from hive_tpu_torch.scripts.compare_image_pair import compare_images

    start = time.perf_counter()
    card = whole = compare_images(image_a, image_b, device=device)
    card_s = held_s = time.perf_counter() - start
    held_a, held_b = image_a, image_b
    if crop is not None:
        held_a, held_b = (np.ascontiguousarray(x[:crop[0], :crop[1]])
                          for x in (image_a, image_b))
        start = time.perf_counter()
        card = compare_images(held_a, held_b, device=device)
        held_s = time.perf_counter() - start
    start = time.perf_counter()
    cpu = compare_images(held_a, held_b, device="cpu")
    cpu_s = time.perf_counter() - start
    for metric in ("ssim", "psnr"):
        if not abs(card[metric] - cpu[metric]) <= COMPARE_SSIM_PSNR_RTOL * abs(cpu[metric]):
            raise AssertionError(f"{name}: {metric} on the card {card[metric]!r}, on the CPU "
                                 f"{cpu[metric]!r}")
    both_nan = np.isnan(card["mifd"]) and np.isnan(cpu["mifd"])
    mifd_err = 0.0 if both_nan else abs(card["mifd"] - cpu["mifd"]) / abs(cpu["mifd"])
    if not mifd_err <= EVAL_MIFD_RTOL:
        raise AssertionError(f"{name}: MIFD on the card {card['mifd']!r}, on the CPU "
                             f"{cpu['mifd']!r}")
    notes = metrics.metric_skip_notes({"lpips": [card["lpips"]]}, device)
    if not (np.isnan(card["lpips"]) and np.isnan(cpu["lpips"])
            and notes == {"lpips": "skipped: weights absent"}):
        raise AssertionError(f"{name}: LPIPS {card['lpips']} / {cpu['lpips']}, notes {notes}")
    timed = {"ssim_psnr": device_profile(
        lambda: metrics.ssim_psnr(image_a, image_b, device=device), reps=3, warmup=1),
             "mifd": device_profile(lambda: metrics.mifd(image_a, image_b, device=device),
                                    reps=1, warmup=0)}
    log(f"[research] compare-pair {name}"
        + (f": the whole pair on the card SSIM {whole['ssim']!r}, PSNR {whole['psnr']!r} dB, "
           f"MIFD {whole['mifd']!r} px ({card_s:.2f} s); held to the CPU on the top-left "
           if crop is not None else " ")
        + f"({held_a.shape[1]}x{held_a.shape[0]}): SSIM "
        f"{card['ssim']!r}, PSNR {card['psnr']!r} dB, MIFD {card['mifd']!r} px on the card "
        f"({held_s:.2f} s); the CPU's ({cpu_s:.2f} s) SSIM {cpu['ssim']!r}, PSNR "
        f"{cpu['psnr']!r}, MIFD {cpu['mifd']!r} ({mifd_err:.3e} relative); "
        f"LPIPS NaN, {notes['lpips']}; device ms / kernels "
        f"({image_a.shape[1]}x{image_a.shape[0]}): "
        + ", ".join(f"{k} {ms:.4f} / {ops:.0f}" for k, (ms, ops) in timed.items()))
    return dict(card=card, cpu=cpu, whole=whole, mifd_err=mifd_err, card_s=card_s, cpu_s=cpu_s,
                timed={k: {"ms": ms, "kernels": ops} for k, (ms, ops) in timed.items()})


def read_json_and_tex(out: str) -> dict:
    """Every JSON and LaTeX file the harness wrote, parsed: the JSON by
    ``json.load``, each table as LaTeX's tabular (begin, header, rule, rows,
    end, caption). Returns the parsed JSON by path and the tables' rows."""
    parsed, tables = {}, {}
    for root, _, files in os.walk(out):
        for name in files:
            path = os.path.join(root, name)
            rel = os.path.relpath(path, out)
            if name.endswith(".json"):
                with open(path) as f:
                    parsed[rel] = json.load(f)
            elif name.endswith(".tex"):
                with open(path) as f:
                    lines = f.read().split("\n")
                spec = lines[0].removeprefix(r"\begin{tabular}{").removesuffix("}")
                if not (spec[:1] == "l" and set(spec[1:]) <= {"r"} and lines[2] == r"\hline"
                        and lines[-2] == r"\end{tabular}" and lines[-1].startswith("% ")
                        and all(line.endswith(r" \\") and line.count(" & ") == len(spec) - 1
                                for line in lines[1:2] + lines[3:-2])):
                    raise AssertionError(f"{rel} is no tabular:\n" + "\n".join(lines))
                tables[rel] = [line[:-3].split(" & ") for line in lines[3:-2]]
    return {"json": parsed, "tables": tables}


def run_research_experiments(device, launches, tmp: str) -> dict:
    """experiments-tum: ``hive_tpu_torch.scripts.experiments.main`` in this
    process on phase 7's TUM folder (``<tmp>/tum``) with every group but the
    render-vs-photo ones and the configs of RESEARCH_CONFIGS, at the CLI's default voxel
    budget, DPT and LPIPS without weights. Each config's pipeline run and
    the whole harness launch two classifications and one band update per
    integrated frame; the gt run's ``bg.glb`` equals a CLI run's with the
    options the harness passes; every JSON and LaTeX file parses; the
    estimated trajectories' ATE is finite. Logs each group's and config's
    wall time and the peak device memory."""
    from hive_tpu_torch import metrics
    from hive_tpu_torch.io import HiveDataset
    from hive_tpu_torch.ops.tsdf_sparse import SparseTSDFVolume
    from hive_tpu_torch.pipeline import Pipeline
    from hive_tpu_torch.scripts import experiments

    out = os.path.join(tmp, "research")
    integrated = [0]
    runs, groups = {}, {}
    integrate, pipeline_run = SparseTSDFVolume.integrate_frames, Pipeline.run

    def counting_integrate(self, colors, *args, **kwargs):
        integrated[0] += len(colors)
        return integrate(self, colors, *args, **kwargs)

    def measured_run(self, *args, **kwargs):
        config = os.path.basename(os.path.dirname(self.storage_options.output_path))
        reset_launch_counts()
        before = integrated[0]
        torch.cuda.synchronize()
        start = time.perf_counter()
        result = pipeline_run(self, *args, **kwargs)
        torch.cuda.synchronize()
        runs[config] = dict(wall_s=time.perf_counter() - start, launches=main_launch_counts(),
                            frames=integrated[0] - before)
        return result

    def timed(method):
        original = getattr(experiments.Experiments, method)

        def call(self, *args, **kwargs):
            start = time.perf_counter()
            result = original(self, *args, **kwargs)
            groups[method] = time.perf_counter() - start
            return result
        return call

    argv = ["--data_path", tmp, "--output_path", out, "--dataset_names", "tum",
            "--num_frames", str(TUM_FRAMES), "--experiments", *RESEARCH_GROUPS]
    patches = [mock.patch.object(SparseTSDFVolume, "integrate_frames", counting_integrate),
               mock.patch.object(Pipeline, "run", measured_run),
               mock.patch.object(experiments.Experiments, "CONFIGS",
                                 {c: experiments.Experiments.CONFIGS[c] for c in RESEARCH_CONFIGS})]
    patches += [mock.patch.object(experiments.Experiments, m, timed(m)) for m in RESEARCH_METHODS]
    weights = os.path.join(tmp, "research_weights")
    os.makedirs(weights)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    start = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for patch in patches:
            stack.enter_context(patch)
        stack.enter_context(mock.patch.dict(os.environ, {"WEIGHTS_PATH": weights}))
        stack.enter_context(mock.patch.dict(metrics._lpips_models, clear=True))
        experiments.main(argv, device=device)
    wall = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated(device)

    if set(runs) != set(RESEARCH_CONFIGS):
        raise AssertionError(f"the harness ran the pipeline for {sorted(runs)}; see "
                             f"{out}/experiments.log")
    for config, run in runs.items():
        check_launches(f"experiments {config}", run["launches"], run["frames"])
    found = read_json_and_tex(out)
    profiling = found["json"]["pipeline_profiling.json"]["tum"]
    if list(profiling) != list(RESEARCH_CONFIGS):
        raise AssertionError(f"pipeline_profiling.json holds {list(profiling)}")
    expected = {"pipeline_profiling.json", "trajectory_results.json",
                "mesh_compression_results.json", "inpainting_results.json",
                "tum/trajectory/trajectory_metrics.json", "tum/inpainting/inpainting_metrics.json",
                *(f"tum/{c}/dataset/profiling.json" for c in RESEARCH_CONFIGS)}
    missing = expected - set(found["json"])
    tables = found["tables"]
    if missing or set(tables) != {"pipeline_results.tex", "compression_results.tex"}:
        raise AssertionError(f"missing {sorted(missing)}; tables {sorted(tables)}")
    if [row[0] for row in tables["pipeline_results.tex"]] != [f"tum/{c}" for c in
                                                              RESEARCH_CONFIGS]:
        raise AssertionError(f"pipeline_results.tex rows {tables['pipeline_results.tex']}")
    matrix = found["json"]["mesh_compression_results.json"]
    for config in RESEARCH_CONFIGS:
        entry = matrix.get(f"tum/{config}", {})
        if entry.get("bg", {}).get("method") not in ("quantization", "draco") or not np.isfinite(
                entry.get("render_comparison", {}).get("ssim", np.nan)):
            raise AssertionError(f"mesh compression of {config}: {entry}")

    gt = HiveDataset(os.path.join(out, "tum", "gt", "dataset")).camera_trajectory
    ate = {c: ate_m(gt.values, HiveDataset(os.path.join(out, "tum", c, "dataset")
                                           ).camera_trajectory.values)
           for c in RESEARCH_CONFIGS[1:]}
    if not all(np.isfinite(v) for v in ate.values()):
        raise AssertionError(f"ATE of the estimated configs {ate}")

    # The gt run against the CLI with the options the harness passes.
    cli = os.path.join(tmp, "research_cli")
    cli_argv = ["hive_tpu_torch", "--dataset_path", os.path.join(tmp, "tum"),
                "--output_path", cli, "--num_frames", str(TUM_FRAMES), "--frame_step", "15",
                "--webxr_path", os.path.join(tmp, "research_cli_webxr"),
                "--log_file", os.path.join(tmp, "research_cli.log")]
    reset_launch_counts()
    before = integrated[0]
    with mock.patch.object(sys, "argv", cli_argv), \
            mock.patch.object(SparseTSDFVolume, "integrate_frames", counting_integrate):
        runpy.run_module("hive_tpu_torch", run_name="__main__", alter_sys=True)
    launches["research_cli"] = main_launch_counts()
    check_launches("the CLI run beside the harness", launches["research_cli"],
                   integrated[0] - before)
    with open(os.path.join(out, "tum", "gt", "dataset", "mesh", "bg.glb"), "rb") as f:
        harness_glb = f.read()
    with open(os.path.join(cli, "mesh", "bg.glb"), "rb") as f:
        cli_glb = f.read()
    if harness_glb != cli_glb:
        raise AssertionError(f"the harness's gt bg.glb ({len(harness_glb)} B) differs from the "
                             f"CLI's ({len(cli_glb)} B)")
    launches["research"] = {name: sum(run["launches"][name] for run in runs.values())
                            for name in runs["gt"]["launches"]}
    trajectory = found["json"]["trajectory_results.json"].get("tum", {})
    inpainting = found["json"]["inpainting_results.json"].get("tum", {})
    log(f"[research] experiments-tum: main({' '.join(argv[4:])}) in {wall:.1f} s, peak device "
        f"memory {peak} B; groups (s): "
        + ", ".join(f"{m.removeprefix('run_')} {s:.2f}" for m, s in groups.items())
        + "; configs: " + "; ".join(
            f"{c} {r['wall_s']:.2f} s, {r['frames']} integrated frames, launches "
            f"{r['launches']}, {profiling[c]['elapsed_time']['per_frame']:.4f} s/frame, peak "
            f"{profiling[c]['peak_vram_usage']['allocated']} B" for c, r in runs.items()))
    log(f"[research] experiments-tum: the gt bg.glb ({len(harness_glb)} B) equals the CLI's "
        f"(--num_frames {TUM_FRAMES} --frame_step 15; launches {launches['research_cli']}); "
        f"ATE (m) est {ate['est']!r}; the trajectory group's pose optimiser "
        f"on gt {json.dumps(trajectory)}; inpainting means {json.dumps(inpainting)}; mesh "
        f"compression " + json.dumps({k: {p: v[p].get("compression_ratio") for p in ("fg", "bg")
                                          if p in v} for k, v in matrix.items() if k != "mean"})
        + "; files: " + ", ".join(sorted(found["json"]) + sorted(tables)))
    return dict(wall_s=wall, peak_bytes=peak, groups=groups, configs=runs, ate_m=ate,
                trajectory=trajectory, inpainting=inpainting, glb_bytes=len(harness_glb),
                files=sorted(found["json"]) + sorted(tables))


def check_research(device, launches, tmp: str) -> dict:
    """[research]: experiments-tum, compare-pair (a rendered view of the gt
    export against the photo it replaces at 640x480; the panoptic nodes'
    synced 1080p frames) and panoptic."""
    from hive_tpu_torch import metrics
    from hive_tpu_torch.io import HiveDataset
    from hive_tpu_torch.meshing.gltf import load_glb
    from hive_tpu_torch.meshing.render import render_scene_counted

    phase_start = time.perf_counter()
    harness = run_research_experiments(device, launches, tmp)

    gt = os.path.join(tmp, "research", "tum", "gt", "dataset")
    dataset = HiveDataset(gt)
    background = load_glb(os.path.join(gt, "mesh", "bg.glb"))
    foreground = load_glb(os.path.join(gt, "mesh", "fg.glb"))
    offset = export_offset(dataset)
    frame = 15
    R, t = export_pose(dataset.camera_trajectory.to_homogenous_transforms()[frame], offset)
    photo = dataset.rgb_dataset[frame]
    view, _, _ = render_scene_counted(view_scene(background, foreground, frame),
                                      dataset.camera_matrix, R, t, photo.shape[1],
                                      photo.shape[0], device=device)
    weights = os.path.join(tmp, "research_weights")
    with mock.patch.dict(os.environ, {"WEIGHTS_PATH": weights}), \
            mock.patch.dict(metrics._lpips_models, clear=True):
        vga = compare_on_card_and_cpu("gt view 15 vs its photo", photo, view, device)
        panoptic = check_panoptic(tmp)
        hd = max(PANOPTIC_HD) - 1
        pair = [panoptic["pairs"][node, hd] for node in PANOPTIC_LOADED]
        full_hd = compare_on_card_and_cpu(
            f"panoptic nodes {list(PANOPTIC_LOADED)} at HD frame {hd}", *pair, device,
            crop=PANOPTIC_CPU_CROP)
    if not np.isfinite(full_hd["whole"]["mifd"]):
        raise AssertionError(f"MIFD between the panoptic nodes' frames: {full_hd['whole']}")
    ordered = check_ordered_hist(device, pair[0])
    total = time.perf_counter() - phase_start
    log(f"[research] the phase took {total:.1f} s")
    return dict(experiments=harness, compare_vga=vga, compare_1080p=full_hd,
                panoptic={k: v for k, v in panoptic.items() if k != "pairs"},
                ordered_hist=ordered, phase_s=total)


# Layouts the ordered histogram must sum as the CPU does, (layout, rows,
# entries, bins); the CPU tests (tests/test_torch_numerics.py) run them as
# they are, the card's checks with WARPS_PER_BLOCK x rows + 3 rows (not a
# multiple of the kernel's rows a block). Values spread over 2^-20 .. 2^20,
# so that another order of adds gives other sums.
ORDERED_HIST_LAYOUTS = (
    ("random", 3, 200, 36), ("random", 5, 1000, 360), ("random", 1, 7, 4),
    ("random", 4, 0, 36), ("one_bin", 3, 1089, 36), ("signed_zeros", 3, 1089, 36),
    ("out_of_range", 3, 1089, 360), ("runs", 3, 1089, 360), ("runs", 2, 16200, 360),
    ("random", 2, 1089, 1), ("random", 2, 1089, 512), ("one_bin", 2, 0, 512))


def ordered_hist_case(layout: str, rows: int, entries: int, bins: int, rng):
    """(index, value), int32 and float32 numpy arrays of one layout:
    ``random`` bins; ``one_bin`` every entry of a row in one bin;
    ``signed_zeros`` every other entry +0 or -0, the first -0, and a first
    row of zeros alone; ``out_of_range`` a third of the indices outside
    [0, bins) (to be skipped); ``runs`` runs of one bin 1 to 40 entries
    long, as neighbouring SIFT samples give."""
    index = rng.integers(0, bins, (rows, entries)).astype(np.int32)
    value = (rng.standard_normal((rows, entries))
             * np.ldexp(1.0, rng.integers(-20, 20, (rows, entries)))).astype(np.float32)
    if layout == "one_bin":
        index[:] = rng.integers(0, bins, (rows, 1))
    elif layout == "signed_zeros":
        value[:, 0::2] = np.where(rng.random((rows, (entries + 1) // 2)) < 0.5, -0.0, 0.0)
        value[:, 0] = -0.0
        value[0, 1::2] = np.where(rng.random(entries // 2) < 0.5, -0.0, 0.0)
    elif layout == "out_of_range":
        outside = rng.random((rows, entries)) < 1 / 3
        index[outside] = rng.choice(np.array([-1, -bins, bins, bins + 7, -2 ** 31, 2 ** 31 - 1]),
                                    outside.sum())
    elif layout == "runs":
        for r in range(rows):
            lengths = rng.integers(1, 41, entries)
            run_bins = rng.integers(0, bins, entries)
            index[r] = np.repeat(run_bins, lengths)[:entries]
    elif layout != "random":
        raise ValueError(f"unknown layout {layout}")
    return index, value


def ordered_hist_in_range(index: np.ndarray, value: np.ndarray, bins: int):
    """The entries the kernel adds, as the plain version takes them (it
    refuses an index outside [0, bins)): others sent to bin 0 with +0,
    which leaves every sum as it is."""
    inside = (index >= 0) & (index < bins)
    return (np.where(inside, index, 0).astype(np.int32),
            np.where(inside, value, np.float32(0.0)).astype(np.float32))


def check_ordered_hist_layouts(device, layouts=ORDERED_HIST_LAYOUTS) -> list:
    """The kernel against its plain version on the CPU, bit for bit, on each
    of ``layouts`` with WARPS_PER_BLOCK x rows + 3 rows."""
    from hive_tpu_torch.ops import ordered_hist as oh

    checked = []
    for layout, rows, entries, bins in layouts:
        rows = rows * oh.WARPS_PER_BLOCK + 3
        rng = np.random.default_rng(rows * 1000 + entries)
        index, value = ordered_hist_case(layout, rows, entries, bins, rng)
        got = oh.ordered_hist(torch.from_numpy(index).to(device),
                              torch.from_numpy(value).to(device), bins)
        want = oh.ordered_hist_plain(*map(torch.from_numpy,
                                          ordered_hist_in_range(index, value, bins)), bins)
        if not torch.equal(got.cpu().view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"[ordered_hist] the kernel differs from its plain version on "
                                 f"the {layout} layout, {rows} x {entries} -> {bins} bins")
        checked.append(f"{layout} {rows}x{entries}->{bins}")
    return checked


def deterministic_scatter_add(sums, wide, value):
    """``sums.scatter_add_(1, wide, value)`` under
    ``torch.use_deterministic_algorithms(True)``, the mode restored after."""
    mode = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True)
    try:
        return sums.scatter_add_(1, wide, value)
    finally:
        torch.use_deterministic_algorithms(mode[0], warn_only=mode[1])


def check_ordered_hist(device, image: np.ndarray) -> dict:
    """[research] ordered_hist: SIFT on a 1920x1080 Kinoptic frame twice on
    the card and once on the CPU, every keypoint field and descriptor equal
    bit for bit; the kernel against its plain version (the CPU's in-order
    ``scatter_add_``) bit for bit on ORDERED_HIST_LAYOUTS and on the largest
    orientation (36-bin) and descriptor (360-bin) call of the card's run,
    each call timed beside the same ``scatter_add_`` on the card (atomics:
    the library call, and the plain version's time there), beside it under
    ``torch.use_deterministic_algorithms(True)`` (whose sums are checked
    against the plain version's bits too) and beside its bound."""
    from hive_tpu_torch.ops import ordered_hist as oh
    from hive_tpu_torch.ops import sift

    grey = sift.rgb_to_grey(torch.from_numpy(np.ascontiguousarray(image)))
    largest = {}

    def recording(index, value, bins):
        if index.numel() >= largest.get(bins, (torch.zeros(0),))[0].numel():
            largest[bins] = (index.clone(), value.clone())
        return oh.ordered_hist(index, value, bins)

    with mock.patch.object(sift, "ordered_hist", recording):
        first = sift.detect_and_compute(grey.to(device))
    second = sift.detect_and_compute(grey.to(device))
    start = time.perf_counter()
    cpu = sift.detect_and_compute(grey)
    cpu_s = time.perf_counter() - start
    fields = ("xy", "size", "angle", "response", "octave", "descriptors")
    for field in fields:
        a, b, c = (getattr(f, field) for f in (first, second, cpu))
        if not torch.equal(a, b):
            raise AssertionError(f"[ordered_hist] two card runs of SIFT at 1080p differ in "
                                 f"{field}")
        if not torch.equal(a.cpu(), c):
            raise AssertionError(f"[ordered_hist] SIFT at 1080p on the card differs from the "
                                 f"CPU in {field} ({len(first)} vs {len(cpu)} keypoints)")
    layouts = check_ordered_hist_layouts(device)
    calls = {}
    for bins, (index, value) in sorted(largest.items()):
        got = oh.ordered_hist(index, value, bins)
        want = oh.ordered_hist_plain(index.cpu(), value.cpu(), bins).view(torch.int32)
        if not torch.equal(got.cpu().view(torch.int32), want):
            raise AssertionError(f"[ordered_hist] the kernel differs from its plain version "
                                 f"at {tuple(index.shape)} x {bins} bins")
        rows, entries = index.shape
        # Bytes: each entry's index and value read once, each sum written
        # once; operations: one add an entry.
        bound_ms, bound_by = bound(rows * entries * 8 + rows * bins * 4, rows * entries)
        sums, wide = torch.zeros((rows, bins), device=device), index.long()
        det = deterministic_scatter_add(torch.zeros_like(sums), wide, value)
        calls[bins] = dict(
            ms=device_time_ms(lambda: oh.ordered_hist(index, value, bins), reps=5, warmup=1),
            plain_ms=device_time_ms(lambda: oh.ordered_hist_plain(index, value, bins),
                                    reps=10, warmup=2),
            library_ms=device_time_ms(lambda: sums.scatter_add_(1, wide, value), reps=10,
                                      warmup=2),
            library_det_ms=device_time_ms(lambda: deterministic_scatter_add(sums, wide, value),
                                          reps=10, warmup=2),
            library_det_equal=bool(torch.equal(det.cpu().view(torch.int32), want)),
            bound_ms=bound_ms, bound_by=bound_by, max_abs_err=0.0,
            shape=f"{rows} rows x {entries} entries -> {bins} bins")
    log(f"[ordered_hist] SIFT at {image.shape[1]}x{image.shape[0]}: {len(first)} keypoints; "
        f"two card runs equal and equal to the CPU's ({cpu_s:.1f} s) in "
        f"{', '.join(fields)}; the kernel equals its plain version bit for bit on the layouts "
        f"{', '.join(layouts)} and on "
        + "; ".join(f"{c['shape']}: {c['ms']:.6f} ms device (plain, scatter_add_ on the card: "
                    f"{c['plain_ms']:.6f}; library {c['library_ms']:.6f}; deterministic "
                    f"scatter_add_ {c['library_det_ms']:.6f}, "
                    f"{'equal' if c['library_det_equal'] else 'not equal'} to the plain "
                    f"version's bits; bound {c['bound_ms']:.7f}, {c['bound_by']})"
                    for c in calls.values()))
    return dict(keypoints=len(first), cpu_s=cpu_s, layouts=layouts, calls=calls)


@contextlib.contextmanager
def recording_ordered_hist_shapes(shapes: list):
    """Appends (rows, entries, bins) of each ordered_hist call SIFT makes
    to ``shapes``."""
    from hive_tpu_torch.ops import ordered_hist as oh
    from hive_tpu_torch.ops import sift

    def recording(index, value, bins):
        shapes.append((*index.shape, bins))
        return oh.ordered_hist(index, value, bins)

    with mock.patch.object(sift, "ordered_hist", recording):
        yield shapes


def launch_floor_ms(device) -> float:
    """Device ms of a one-element ``add_``: what any launch costs."""
    one = torch.zeros(1, device=device)
    ms = device_time_ms(lambda: one.add_(1.0), reps=50, warmup=5)
    log(f"[launch floor] a one-element add_: {ms:.6f} ms device")
    return ms


# ---------------------------------------------------------------------------
# The measurement entry points' kernels.
# ---------------------------------------------------------------------------

# Operations per voxel of the fused trip (csrc/fused_band.cu), each f32 or
# integer instruction-level operation counted once (a division as one):
# projection 27 (3 adds, 3 x (mul, 2 FMAs, add), the z guard, 2 x (mul, div,
# add, round, convert)); view test, clamps and window address 19; unpack 15;
# update 26 (sdf, 4 tests, dist, clamp, weights, 4 x (mul, FMA, div, select)).
FUSED_OPS_PER_VOXEL = {True: 87, False: 60}


def exact_or_raise(name, pairs):
    """Largest |difference| over (got, want) pairs, raising if any bit differs."""
    worst = 0.0
    for got, want in pairs:
        if int(bit_differences(got, want)):
            raise AssertionError(f"{name} kernel differs from its plain version")
        worst = max(worst, float(max_abs_err(got, want)))
    return worst


def check_tile_gather(device):
    from hive_tpu_torch.micro.gather import q1_inputs
    from hive_tpu_torch.ops import tile_gather as tg

    src, idx, ridx = (torch.as_tensor(x, device=device) for x in q1_inputs())
    err = exact_or_raise("tile_gather", [(tg.tile_gather(src, i, axis),
                                          tg.tile_gather_plain(src, i, axis))
                                         for axis, i in ((1, idx), (0, ridx))])
    index = idx.long()
    n = src.numel()
    # Bytes: tile, indices and output once. Operations per element: clamp
    # (2), row/column split (2), address (2).
    bound_ms, bound_by = bound(n * 12, n * 6)
    times = dict(
        ms=device_time_ms(lambda: tg.tile_gather(src, idx, 1), reps=200),
        ms_axis0=device_time_ms(lambda: tg.tile_gather(src, ridx, 0), reps=200),
        plain_ms=device_time_ms(lambda: tg.tile_gather_plain(src, idx, 1), reps=200),
        loop_ms=events_ms(lambda: tg.tile_gather(src, idx, 1), reps=200),
        library_ms=device_time_ms(lambda: torch.gather(src, 1, index), reps=200),
        library="torch.gather", bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
        shape="tile (8, 128) int32, indices (8, 128) int32, axis 1 (axis 0: ms_axis0)")
    log_times("tile_gather, gather probe's tile, exact on both axes", times)
    return times


def check_patch_gather(device):
    from hive_tpu_torch.micro import gather as mg
    from hive_tpu_torch.ops import band_sampler as bs
    from hive_tpu_torch.ops import patch_gather as pg

    img, v0, u0, vv, uu = mg.q2_inputs()
    rng = np.random.default_rng(SEED)
    # One sample in eight leaves its window by a whole window height or width.
    away = rng.random(vv.shape) < 1 / 8
    down = rng.random(vv.shape) < 0.5
    vv_out = np.where(away & down, vv + rng.choice([-mg.PH, mg.PH], vv.shape), vv)
    uu_out = np.where(away & ~down, uu + rng.choice([-mg.PW, mg.PW], uu.shape), uu)
    frame, v0, u0, vv, uu, vv_out, uu_out = (
        torch.as_tensor(x.astype(np.int32), device=device)
        for x in (img, v0, u0, vv, uu, vv_out, uu_out))
    args = (v0, u0, frame, vv_out, uu_out, mg.PH, mg.PW)
    got = pg.patch_gather(*args)
    away = torch.as_tensor(away, device=device)
    if not (torch.equal(got[away], torch.zeros_like(got[away]))
            and torch.equal(got[~away], frame[vv.long(), uu.long()][~away])):
        raise AssertionError("patch_gather's words differ from the frame's")
    err = exact_or_raise("patch_gather", [(got, pg.patch_gather_plain(*args)),
                                          (pg.patch_gather(v0, u0, frame, vv, uu, mg.PH, mg.PW),
                                           pg.patch_gather_plain(v0, u0, frame, vv, uu,
                                                                 mg.PH, mg.PW))])

    flat = (vv.long() * frame.shape[1] + uu.long()).contiguous()
    n = vv.numel()
    # Bytes: each distinct sampled word once, v0/u0 per block, vv/uu in and
    # the word out per sample. Operations per sample: two offsets, four
    # window tests, the shared-memory address and select (8).
    bound_ms, bound_by = bound(torch.unique(flat).numel() * 4 + v0.numel() * 8 + n * 12,
                               n * 8)
    times = dict(
        ms=device_time_ms(lambda: pg.patch_gather(v0, u0, frame, vv, uu, mg.PH, mg.PW)),
        plain_ms=device_time_ms(lambda: pg.patch_gather_plain(v0, u0, frame, vv, uu,
                                                              mg.PH, mg.PW), reps=20),
        loop_ms=events_ms(lambda: pg.patch_gather(v0, u0, frame, vv, uu, mg.PH, mg.PW)),
        library_ms=device_time_ms(lambda: torch.take(frame, flat)), library="torch.take",
        band_sampler_ms=device_time_ms(lambda: bs.band_sample(frame, vv, uu)),
        bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
        shape=f"frame {tuple(frame.shape)} int32, {v0.numel()} blocks x "
              f"{n // v0.numel()} samples, {mg.PH}x{mg.PW} windows")
    log_times("patch_gather, gather probe's Q2, exact (1/8 of samples outside their "
              f"windows give 0); band_sample {times['band_sampler_ms']:.6f} ms", times)
    return times


def check_fused_band(device):
    from hive_tpu_torch.micro import fused_band as mf
    from hive_tpu_torch.ops import fused_band as fb

    s = mf.setup(device)
    st, sw, sc = s["state"]
    ids, frame = s["ids"], s["frame"]
    valid = (ids < mf.NBS).to(torch.int32)
    rid = torch.clamp(ids, max=mf.NBS - 1)
    scal = torch.cat([s["obs_weight"].reshape(1), s["R"].reshape(-1), s["t"].reshape(-1)])
    iota = s["iota"]
    cz, uu, vv = mf.project(s["origins"], s["R"], s["t"], iota)
    options = dict(intr=mf.INTR, trunc=mf.TRUNC, window=(mf.PH, mf.PW))

    def rows():
        return st[rid], sw[rid], sc[rid]

    def call(fn, pik, state):
        coords = iota if pik else (vv, uu, cz)
        return fn(s["win_v0"], s["win_u0"], valid, scal, s["origins"], frame, coords, *state,
                  project_in_kernel=pik, **options)

    pairs = []
    for pik in (True, False):
        pairs += zip(call(fb.fused_band, pik, rows()), call(fb.fused_band_plain, pik, rows()))
    err = exact_or_raise("fused_band", pairs)

    # Bytes: each distinct frame word the trip reads (at its window-clamped
    # pixel) once, 40 B of row state per voxel in and out, the row's window
    # origin, valid flag and block origin, the 13 scalars, and the offsets
    # (full) or v, u, cam_z per voxel (half-fused).
    height, width = frame.shape
    pixel = torch.arange(height * width, device=device, dtype=torch.int32).view(height, width)
    words = torch.unique(fb.window_sample(pixel, s["win_v0"], s["win_u0"], vv, uu,
                                          mf.PH, mf.PW)).numel()
    k, n = ids.numel(), vv.numel()
    common = words * 4 + n * 40 + k * (12 + 12) + 13 * 4

    def timed(pik):
        state_k, state_p = rows(), rows()
        return (device_time_ms(lambda: call(fb.fused_band, pik, state_k)),
                device_time_ms(lambda: call(fb.fused_band_plain, pik, state_p), reps=20),
                events_ms(lambda: call(fb.fused_band, pik, state_k)),
                bound(common + (iota.numel() * 4 if pik else n * 12),
                      n * FUSED_OPS_PER_VOXEL[pik]))

    ms, plain_ms, loop_ms, (bound_ms, bound_by) = timed(True)
    half_ms, half_plain_ms, half_loop_ms, (half_bound_ms, _) = timed(False)
    times = dict(ms=ms, plain_ms=plain_ms, loop_ms=loop_ms, library_ms=None,
                 bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
                 half_fused=dict(ms=half_ms, plain_ms=half_plain_ms, loop_ms=half_loop_ms,
                                 bound_ms=half_bound_ms),
                 shape=f"{k} rows x {mf.BV} voxels, frame {tuple(frame.shape)} int32, "
                       f"{mf.PH}x{mf.PW} windows, projection in the kernel")
    log_times("fused_band, fused-trip probe's trip, both variants exact", times)
    log(f"[fused_band] half-fused: kernel={half_ms:.6f} ms plain={half_plain_ms:.6f} ms "
        f"(profiler); launch loop {half_loop_ms:.6f} ms/call; bound={half_bound_ms:.7f} ms")
    return times


def run_entry_points(device, launches):
    """Both measurement entry points, each with its kernels' launch counts
    reset just before and read just after its run."""
    from hive_tpu_torch.micro import fused_band as mf
    from hive_tpu_torch.micro import gather as mg
    from hive_tpu_torch.ops import band_sampler, fused_band, patch_gather, tile_gather

    tile_gather.launches = patch_gather.launches = band_sampler.launches = 0
    torch.cuda.synchronize()
    gather = mg.run(device)
    torch.cuda.synchronize()
    launches["micro.gather"] = {"tile_gather": tile_gather.launches,
                                "patch_gather": patch_gather.launches,
                                "band_sampler": band_sampler.launches}

    fused_band.launches = band_sampler.launches = 0
    torch.cuda.synchronize()
    fused = mf.run(device)
    torch.cuda.synchronize()
    launches["micro.fused_band"] = {"fused_band": fused_band.launches,
                                    "band_sampler": band_sampler.launches}

    for entry, result in (("micro.gather", gather), ("micro.fused_band", fused)):
        if not result["ok"]:
            raise AssertionError(f"{entry} found a wrong result: {result}")
    if fused["fits"] != mf.K:
        raise AssertionError(f"only {fused['fits']}/{mf.K} rows fit their windows")
    for entry, counts in (("micro.gather", launches["micro.gather"]),
                          ("micro.fused_band", launches["micro.fused_band"])):
        if min(counts.values()) == 0:
            raise AssertionError(f"{entry} skipped a kernel: {counts}")
    log(f"[entry points] launches {launches['micro.gather']} (micro.gather), "
        f"{launches['micro.fused_band']} (micro.fused_band); {timing.retakes} profiler "
        f"traces retaken so far in this process")
    return {"micro.gather": gather, "micro.fused_band": fused}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from hive_tpu_torch import get_device, native
    from hive_tpu_torch.ops import cuda_build

    device = get_device()
    smi = nvidia_smi_line()
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}; nvidia-smi: {smi}")
    log(f"[device] video tools on PATH: {video_tools()}")
    log(f"[device] video decoder libraries (ctypes.util.find_library): {decoder_libraries()}")
    log(f"[device] NVIDIA_DRIVER_CAPABILITIES={os.environ.get('NVIDIA_DRIVER_CAPABILITIES')}; "
        f"cuvidGetDecoderCaps, 8-bit 4:2:0 at {STRAY_W}x{STRAY_H}: {nvdec_caps_log()}")

    script_start = start = time.perf_counter()
    cuda_build.build(["classify_blocks", "band_update", "band_sampler", "tile_gather",
                      "patch_gather", "fused_band", "ordered_hist"])
    log(f"[build] all seven kernels in {time.perf_counter() - start:.1f} s")
    # The host library (extraction weld, QEM decimation, frame decoders)
    # builds at first use; built here, its g++ time stays out of the e2e
    # run's stage times.
    start = time.perf_counter()
    if native.get_native_lib() is None:
        raise RuntimeError("the native host library did not build")
    log(f"[build] the native host library (g++) in {time.perf_counter() - start:.1f} s")

    frames = bench_frames(device)
    bench = {**check_classify(device, frames),
             "band_update": check_band_update(device, frames)}
    check_band_update_states(device)
    sampler = check_sampler(device, frames)
    launches = {}
    phase_seconds = {"to_integration": time.perf_counter() - script_start}
    check_integration(device, frames, launches)
    check_sparse_vs_dense(device)
    del frames
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="hive_tum_") as tmp:
        e2e = os.path.join(tmp, "e2e")
        phase_start = time.perf_counter()
        main_path, main_profiling = run_main_path(device, launches, keep=e2e)
        phase_seconds["e2e"] = time.perf_counter() - phase_start
        phase_start = time.perf_counter()
        shards = check_shards(device, launches, e2e, tmp, smi)
        phase_seconds["shard"] = time.perf_counter() - phase_start
        phase_start = time.perf_counter()
        conversion, conversion_profiling = run_conversion(device, launches, main_profiling, tmp)
        phase_seconds["convert"] = time.perf_counter() - phase_start
        phase_start = time.perf_counter()
        dpt_results = check_dpt(device)
        phase_seconds["dpt"] = time.perf_counter() - phase_start
        phase_start = time.perf_counter()
        depth_run = run_depth_conversion(device, launches, conversion_profiling, tmp)
        phase_seconds["estimate_depth"] = time.perf_counter() - phase_start
        phase_start = time.perf_counter()
        segmenters = check_segmenters(device, os.path.join(tmp, "tum"))
        phase_seconds["segment"] = time.perf_counter() - phase_start
        phase_start = time.perf_counter()
        segmented_run = run_segmented_conversion(device, launches, conversion_profiling, tmp)
        phase_seconds["maskrcnn_run"] = time.perf_counter() - phase_start
        phase_start = time.perf_counter()
        lama_results = check_lama(device, os.path.join(tmp, "tum"))
        phase_seconds["lama"] = time.perf_counter() - phase_start
        phase_start = time.perf_counter()
        inpainted_run = run_inpainting_conversion(device, launches, conversion_profiling, tmp)
        phase_seconds["inpaint_run"] = time.perf_counter() - phase_start
        phase_start = time.perf_counter()
        pose_results = {"small": check_pose_small(device), "user": run_pose_optimise(device)}
        phase_seconds["pose"] = time.perf_counter() - phase_start
        phase_start = time.perf_counter()
        fts_run = run_fts_conversion(device, launches, conversion_profiling, tmp)
        phase_seconds["fts"] = time.perf_counter() - phase_start
        phase_start = time.perf_counter()
        colmap_run = run_colmap_pose_conversion(device, launches, conversion_profiling, tmp)
        phase_seconds["colmap"] = time.perf_counter() - phase_start
        probes = {"band_sampler": sampler,
                  "tile_gather": check_tile_gather(device),
                  "patch_gather": check_patch_gather(device),
                  "fused_band": check_fused_band(device)}
        floor = launch_floor_ms(device)
        phase_start = time.perf_counter()
        features = check_features(device)
        phase_seconds["features"] = time.perf_counter() - phase_start
        phase_start = time.perf_counter()
        pnp_run = run_pnp_pose_conversion(device, launches, conversion_profiling, colmap_run,
                                          tmp)
        phase_seconds["pnp"] = time.perf_counter() - phase_start
        phase_start = time.perf_counter()
        video = check_video(device, launches, tmp)
        phase_seconds["video"] = time.perf_counter() - phase_start
        phase_start = time.perf_counter()
        evaluation = check_eval(device, tmp, e2e)
        phase_seconds["eval"] = time.perf_counter() - phase_start
        phase_start = time.perf_counter()
        research = check_research(device, launches, tmp)
        phase_seconds["research"] = time.perf_counter() - phase_start
    phase_start = time.perf_counter()
    entry_points = run_entry_points(device, launches)
    phase_seconds["entry_points"] = time.perf_counter() - phase_start

    # Times, errors and bounds are the main path's own (its largest call);
    # "bench" holds the same at the TSDF bench shape.
    kernels = []
    # The classification's two instantiations come from one source; pass 1
    # replaces XLA code of the reference, the refine pass its Pallas kernel.
    counts = CLASSIFY_COUNTS + BAND_UPDATE_COUNTS
    for name, source, replaces in (
            ("classify_pass1", "classify_blocks", "hive_tpu/ops/tsdf_sparse.py:829"),
            ("classify_refine", "classify_blocks", "hive_tpu/ops/pallas_refine.py:72"),
            ("band_update", "band_update", "hive_tpu/ops/pallas_sampler.py:66")):
        result = main_path[name]
        kernels.append(dict(
            name=name, route="cuda", source=f"hive_tpu_torch/csrc/{source}.cu",
            replaces=replaces, launches=launches["main"][name],
            launches_converted=launches["converted"][name],
            launches_estimated_depth=launches["estimated_depth"][name],
            launches_segmented=launches["segmented"][name],
            launches_inpainted=launches["inpainted"][name],
            launches_fts=launches["fts"][name], launches_colmap_pose=launches["colmap_pose"][name],
            launches_pnp_pose=launches["pnp_pose"][name],
            launches_video_phone=launches["video_phone"][name],
            launches_video_phone_mpeg4=launches["video_phone_mpeg4"][name],
            launches_video_phone_h264_b=launches["video_phone_h264_b"][name],
            launches_video_phone_hevc=launches["video_phone_hevc"][name],
            launches_video_stray=launches["video_stray"][name],
            launches_bench=launches["bench"][name], launches_shard=launches["shard"][name],
            launches_research=launches["research"][name],
            exact=True,
            calls_checked=result["calls_checked"], max_abs_err=result["max_abs_err"],
            ms=result["ms"], kernel_ms=result["ms"], plain_ms=result["plain_ms"],
            loop_ms=result["loop_ms"], bound_ms=result["bound_ms"],
            bound_by=result["bound_by"], library_ms=result["library_ms"],
            shape=result["shape"], **{k: result[k] for k in ("glue_ms", *counts) if k in result},
            bench={k: bench[name][k] for k in ("ms", "glue_ms", "plain_ms", "library_ms",
                                               "loop_ms", "bound_ms", "shape", *counts)
                   if k in bench[name]}))
    # The measurement entry points' kernels: launches are the entry points'
    # runs, times and errors those of the probe phases at their shapes (the
    # band sampler's at the bench shape's 128-row trip, the production
    # trip's width).
    entry_results = {"band_sampler": entry_points["micro.fused_band"]["q3"],
                     "tile_gather": entry_points["micro.gather"]["q1"],
                     "patch_gather": entry_points["micro.gather"]["q2"],
                     "fused_band": entry_points["micro.fused_band"]["q3"]}
    for name, entries, replaces in (
            ("band_sampler", ("micro.gather", "micro.fused_band"),
             "hive_tpu/ops/pallas_sampler.py:66"),
            ("tile_gather", ("micro.gather",), "scripts/micro_pallas_gather.py:72"),
            ("patch_gather", ("micro.gather",), "scripts/micro_pallas_gather.py:113"),
            ("fused_band", ("micro.fused_band",), "scripts/micro_pallas_fused_band.py:134")):
        kernels.append(dict(
            name=name, route="cuda", source=f"hive_tpu_torch/csrc/{name}.cu",
            replaces=replaces, entry_point=", ".join(f"hive_tpu_torch.{e}" for e in entries),
            launches=sum(launches[e][name] for e in entries), exact=True,
            **{k: v for k, v in probes[name].items() if k != "library"}, launch_floor_ms=floor,
            entry_point_result=entry_results[name]))
    # The SIFT histograms' ordered sum (no TPU kernel; it replaces the
    # scatter_add_ of the port's SIFT, hive_tpu's being cv2.SIFT_create):
    # launches are the Motion JPEG phone run's PnP, times those of the
    # 1080p descriptor call (the orientation call's beside them); the
    # shapes of the phone run's and tum-pnp-pose's calls beside them.
    ordered = research["ordered_hist"]["calls"]
    kernels.append(dict(
        name="ordered_hist", route="cuda", source="hive_tpu_torch/csrc/ordered_hist.cu",
        replaces="hive_tpu/sfm.py:55", replaces_note="no TPU kernel: the histogram sums of "
        "cv2.SIFT_create(...).detectAndCompute, in OpenCV's sample order",
        launches=launches["video_phone"]["ordered_hist"],
        launches_phone_mpeg4=launches["video_phone_mpeg4"]["ordered_hist"],
        launches_phone_h264_b=launches["video_phone_h264_b"]["ordered_hist"],
        launches_phone_hevc=launches["video_phone_hevc"]["ordered_hist"],
        launches_pnp_pose=launches["pnp_pose"]["ordered_hist"], exact=True,
        **ordered[360], orientation=ordered[36],
        shapes_phone=video["runs"]["phone"]["ordered_hist_shapes"],
        shapes_phone_mpeg4=video["runs"]["phone_mpeg4"]["ordered_hist_shapes"],
        shapes_phone_h264_b=video["runs"]["phone_h264_b"]["ordered_hist_shapes"],
        shapes_pnp_pose=pnp_run["ordered_hist_shapes"]))
    log("[shard] summary " + json.dumps(shards))
    log("[convert] summary " + json.dumps(conversion))
    log("[dpt] summary " + json.dumps({"model": dpt_results, "estimate_depth_run": depth_run}))
    log("[segment] summary " + json.dumps({"models": segmenters, "maskrcnn_run": segmented_run}))
    log("[inpaint] summary " + json.dumps({"lama": lama_results, "inpainting_run": inpainted_run}))
    log("[pose] summary " + json.dumps({"pose_optimise": pose_results, "fts_run": fts_run,
                                        "colmap_pose_run": colmap_run}))
    log("[features] summary " + json.dumps({"sift_phase": features, "pnp_pose_run": pnp_run}))
    log("[video] summary " + json.dumps(video))
    log("[eval] summary " + json.dumps(evaluation))
    log("[research] summary " + json.dumps(research))
    log(f"[phases] seconds {json.dumps(phase_seconds)}; the script "
        f"{time.perf_counter() - script_start:.1f} s from the build")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
