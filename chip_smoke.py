#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``deepemia_tpu_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --k3-times ROOT   # only K3's timings, see k3_times

Run from the root of a checkout on a machine with one NVIDIA H100 (the
CUDA toolkit's ``nvcc`` under ``$CUDA_HOME``, default ``/usr/local/cuda``).
It builds the CUDA kernels from the sources in the checkout and then:

  1. prints the card's name and power limit, builds the kernels;
  2. holds the RoIAlign kernel against its plain PyTorch version at one
     1024² tile's shapes (box stage 1000 RoIs, about half invalid, 7x7;
     mask stage 100 RoIs, 14x14), in float32 and bfloat16, and times both;
     then on edge cases at 5x5 (the generic kernel instance), 7x7 and
     14x14 in both dtypes (``edge_rois``: elongated 700x4 px boxes, p5
     boxes of a 2048² whole-image pass wider than the output, boxes past
     the level edge and past [-1, size]; an all-invalid set; N = 0);
  3. serves three synthetic 2048² micrographs through ``TileEngine.infer``
     (Mask R-CNN R50-FPN, 2 classes, bf16, seeded random weights with the
     box regression zeroed, default engine settings: 512 px tiles, 0.1
     overlap, x2 upscale, 16-tile batches, native whole-image pass) and
     checks that every RoIAlign of that run went through the kernel;
  4. records the RoIAlign inputs of one real tile batch of that path and
     holds the kernel against the plain version on them (these are the
     timings in the kernel line), then times the stages of one tile batch;
  5. runs a small image through the engine in float32 on the card and on
     the CPU (the plain RoIAlign) and compares the detections;
  7. trains Mask R-CNN R50-FPN through ``train_on_batches()`` (2 classes, 512² batches
     of 2 synthetic micrographs, bf16 compute over float32 master weights,
     Detectron2 capacities, seeded random init with zeroed residual norms):
     6 steps with a checkpoint every 3, then a second ``train_on_batches()`` call to
     step 8 that resumes at 6; checks that every loss is finite, that the
     first step's update of every parameter matches torch's SGD on the CPU
     given the same weights and gradients, and that each step launched the
     RoIAlign forward (K1) and backward (K2) kernels exactly twice (box and
     mask stage); prints seconds per step and peak device memory;
  6. records the RoIAlign inputs and cotangents of one real training step
     (box stage 2x512 RoIs at 7x7, mask stage 2x128 at 14x14, C = 256) and
     holds K2 against its plain version on them, and on a seeded unit-scale
     cotangent, each in bf16 and float32; checks the adjoint identity
     <K1(F), G> = sum_l <F_l, K2(G)_l> on the card, and times K2, its plain
     version and K1 at these shapes; then K2 against its plain version and
     the adjoint identity on phase 2's edge cases, in both dtypes, N = 0,
     and an all-invalid set through ``RoIAlignFunction`` (zero rows, zero
     feature gradients);
  8. runs one float32 training step (128², same weights, batch and sampling
     draws) on the card and on the CPU (plain RoIAlign forward and backward)
     and compares the RPN outputs, the card's proposal selection given the
     CPU's RPN outputs, the losses and every parameter's gradient;
  9. serves three synthetic 2048² micrographs, written as uncompressed TIFF
     by this script with a 300x4 px scale bar and its label ("500 nm",
     "2 um" dark on bright, "1.5 um", glyphs pasted from the reader's atlas
     at 28 px) in the default scale-bar region, through ``run_inference``
     with no config when PyYAML is importable (the store's ``config.yaml``
     and a ``config/datasets/smoke.yaml`` that sets ``scale_bar_roi`` and
     one ``inference_overrides`` value, which must reach the pipeline), else
     through ``InferencePipeline`` under ``validate_config(default_config())``
     after checking that ``get_config`` names the file it cannot read
     (Mask R-CNN R50-FPN, 2 classes, bf16, the seeded phase-3
     weights saved as ``model_final_r50.pt``; the size heuristic, 512 px
     tiles with the x2 upscale the heuristic keeps or drops, multiscale at
     0.7/1.0/1.5/2.0, morphology postprocess, device RLE, native host
     measurements) to both CSVs; checks that every image was processed,
     that the reader read every drawn bar (the value exactly, micrometres
     per pixel within 2 % of value / 300),
     that the RLE rows are the valid instances and decode inside the image,
     that every measurement row belongs to one of them, and that every
     multilevel RoIAlign of the run launched the K1 kernel; holds K1
     against the plain RoIAlign on the first call of every pyramid shape
     and stage of that run (tile batches and whole-image passes of every
     scale) and times it there per launch; prints seconds per image and
     the pipeline's stage seconds;
     then runs one 256² image through the pipeline in float32 on the card
     and on the CPU and compares the two CSVs, and once more on the card
     with every RoIAlign box moved by 0.25 px, which the comparison must
     reject;
 11. the ensemble: phase 9's images and R50 checkpoint beside a seeded
     Mask R-CNN R101-FPN checkpoint (bf16, published widths), through
     ``InferencePipeline`` under the default configuration (ensemble on,
     small classes only; members R101 then R50, one after the other);
     checks that both members ran on every image, that every multilevel
     RoIAlign with RoIs launched K1 in both members, and that every bar was
     read; holds K1 against the plain RoIAlign at the R101 member's first
     shape of each stage; prints seconds per image, R101's trunk + FPN
     seconds per 16-tile batch of 1024² inputs, and the merged instance
     counts. ``python3 -c "import chip_smoke; chip_smoke.ensemble_only()"``
     runs phases 1 and 11 alone;
 12. ``--task inference`` as users start it: the port's CLI
     (``python -m deepemia_tpu_torch.cli.main --task inference --visualize
     --id --draw-scalebar --no-download --no-upload``, run by ``runpy`` in a
     subprocess that reports its stage seconds and RoIAlign counts) on a
     framework home with the phase-3 checkpoint, the default config.yaml,
     phase 9's dataset YAML and phase 9's three micrographs written as LZW,
     Deflate (predictor 2) and PackBits TIFF by this script's own encoders
     (64-row strips); checks that every image was processed, every bar read,
     that each ``*_predictions.png`` and ``class_legend.png`` decode (by the
     port's ``read_image``) to their shapes, and that every multilevel
     RoIAlign with RoIs launched K1; prints each encoding's decode seconds
     and the steady image's stage seconds (``mask_export``, ``rle``,
     ``measurements``, ``overlay``, ``png``). Then, in process: the last
     image with ``measurement_backend: device`` (and the contrast), its
     instances measured on the card and on the CPU (counts,
     extents, perimeters and contrast equal, moments to 1e-5 relative), and
     one 256² image through that pipeline on the card and on the CPU,
     compared as phase 9's reference is; then one 4096² micrograph without
     overlays, whose RLE rows (the windowed device encoder) must equal the
     full-image encoder's on the same instances;
 13. training from a dataset through the port's CLI (``runpy`` of
     ``deepemia_tpu_torch.cli.main`` in this process, ``run_cli``) on ten
     synthetic labelled 1024x768 micrographs written as LZW TIFF with
     per-image label JSONs (10-40 polygons and ellipses, two classes) and a
     ``dataset_info.json`` entry, under the default config (Mask R-CNN
     R50-FPN, 2 x 512² a step, 64 GT slots, bf16, two loader workers):
     ``--task prepare`` (an 8/2 split file); K2 (bf16 and float32) and K1
     against their plain versions, and the adjoint identity, on one
     training step of a 4-image batch from the loader (4 x 512² levels,
     twice the RoIs of a 2-image step); ``train --rcnn 50 --augment
     --max-iter 12`` (finite losses, 2 K1 + 2 K2 launches every step,
     checkpoints and ``model_final_r50.pt``, weights moved; steady seconds
     per step, the step's wait in ``next(loader)`` and its share of the
     wall time); ``evaluate --rcnn 50 --visualize`` (metrics.csv with the
     JAX evaluator's metric names, all finite; one overlay and 2 K1
     launches per test image; K1 against its plain version on the first
     call of each stage, whose levels are non-square: 1024x768 padded to
     /64; seconds and detections per image); ``train --pretrained-weights
     <zoo.pkl>`` for 4 steps from a Detectron2-named pickle of the seeded
     model with 81-class heads (those heads skipped and re-initialised, the
     stem and res2 unchanged); ``train --optimize --n-trials 2 --max-iter 4
     --hpo-strategy random`` (the winner in config.yaml and the dataset
     YAML, no trial directory left); peak device memory;
 10. holds the windowed-sum kernel (K3) against its plain version on the
     conv-chain output of its micro-benchmark and on edge cases
     (``window_sum_edge_cases``: the map exactly the window, C in {1, 3,
     8, 257}, a row pitch off 16 bytes, a base one element off, a
     transposed view, magnitudes 1e4 beside 1e-3), in bf16 and float32,
     printing the plan instance that ran; checks 20 launches bitwise
     equal; times K3, ``torch.sum`` and the empty kernel in turns, per call
     with CUDA events, on the host per call, and per launch on the device
     with ``torch.profiler``, and the plain version; runs the
     micro-benchmark's six variants
     (``deepemia_tpu_torch.tools.bench_decouple``) with K3's launch count
     reset before and read after.
  14. int8 serving and JPEG input: the committed JPEG fixtures
     (``tests/data/torch_jpeg_fixtures.npz``, OpenCV's and PIL's files and
     the arrays ``cv2.imread`` returns) decode bit for bit; a 2048²
     micrograph written by ``jpeg_encode`` (this script's baseline encoder:
     the card's host has no JPEG writer) as gray and colour 4:4:4 / 4:2:2 /
     4:2:0 decodes within JPEG's error, with host seconds; the int8
     implicit-GEMM conv (K4) equals its plain version (max abs diff 0) at
     every distinct conv shape of the R50 trunk and FPN, captured from one
     forward of a 16-tile batch of 1024² inputs and one 2048² whole-image
     pass, in bf16 and float32, with its fused epilogue off and on (the
     conv's own frozen norm and ReLU, each conv3's shortcut as its residual,
     the per-image max of every conv1, conv2 and conv3 output, the maxima
     equal), and where a tile spans three or more images, and is timed per
     shape (CUDA events, the profiler's device time and the host time per
     call) beside its plain version, its bound (the residual's read
     included), bf16 ``F.conv2d`` and, at the 1x1 stride-1 shapes,
     ``torch._int_mm`` (one ``int8_conv {...}`` line per shape); the
     activation quantizer (K5) equals its plain version at every input
     shape it takes there (int8 and per-image max equal, the stem's
     16-channel layout included), in one pass where the input comes with
     its producer's max (which must equal the max the plain version takes
     of it) and in two where not, and is timed beside it, its bound and the
     torch-op chain (one ``int8_quant {...}`` line per shape, with its
     route); one forward launches K4 53 and K5 51 times with ``trunk`` (61
     and 63 with ``full``), and the profiler splits one trunk forward's
     device time into K4, K5's one pass, its two passes and the rest; the
     trunk + FPN seconds of one batch for ``--quantized`` none / trunk /
     full; the float and int8 engines' detections on one micrograph matched
     as INT8_AP.md counts them; the int8 trunk of one 256² and one 253x259
     tile on the card against the plain int8 trunk on the CPU (bit for bit
     at every level); and ``--task inference --quantized trunk``, then
     ``--quantized full``, through the CLI in its own process on phase 9's
     first micrograph as a JPEG (the image processed, its bar read, K4 and
     K5 launched). Phase 13 writes every other image of its
     dataset as JPEG, so train and evaluate read JPEG records.
 15. the entry points users start besides the CLI, on the encodings
     ``read_image`` takes beside the plain ones: the committed fixtures
     (``tests/data/torch_image_fixtures.npz``: PNG, TIFF and BMP files beside
     the arrays ``cv2.imread`` returns) decode bit for bit; phase 9's three
     micrographs, bars drawn, written as an 8-bit palette TIFF (a gray
     ColorMap), a PNG stored transposed with an ``eXIf`` Orientation 5 that
     turns it back, and an RLE8 BMP, each decoding to the raster written
     (host seconds printed); the web panel (``deepemia_tpu_torch.gui.server``,
     in this process on port 0, the admin password set) refuses a wrong
     password with 403, starts ``--task inference --visualize
     --no-download`` on a home holding the transposed PNG (phase 12's
     config, dataset YAML and checkpoint), is polled on /status until the task ends with exit
     code 0, and serves both CSVs through /files and /download and the
     results through /zip; the task ran on the card (the CLI's device line)
     and its rows match phase 12's CLI rows for the same raster (instances
     at mask IoU >= 0.95, at least 0.98 of them); then the wizard (``python
     -m deepemia_tpu_torch.cli.wizard`` in its own process, started from
     the home, with scripted answers: "Run inference" on that dataset with
     ``--quantized trunk``, then "Exit") processes the image on the card,
     reads every bar and launches K1, K4 and K5 (the launches its CLI logs).
     ``python3 -c "import chip_smoke; chip_smoke.entry_points_only()"``
     runs phase 12's CLI run and phase 15 alone.
 16. more than one GPU, on the one card (two shards, members or ranks
     share it; a second physical GPU is not there to run on): (a) phase 3's
     model on one 2048² micrograph through ``TileEngine(device=[cuda:0,
     cuda:0])`` and then with ``--quantized trunk``, each held to the
     one-device engine (``hold_instances``: phase 3's checks and phase 5's
     limits, and whether it is bit-equal), the launches of one sharded
     image counted (K1 6; K4 159 and K5 153 in int8) and both engines
     timed; (b) ``--task inference --chips 2`` through the CLI in its own
     process, which sees ``cuda:0`` twice as the host's GPUs, on phase 11's
     images, checkpoints and configuration: R101 and R50 run at once on
     one-device groups, and the rows are held to phase 11's, which ran them
     in turn; (c) one training step on two ranks on the card
     (``train_on_batches(devices=[cuda:0, cuda:0])``, two started
     processes over gloo) against the one-process step on the same global
     batch, float32 (every weight within RANKS_TOL of the largest update;
     the gap also read in ulps), then
     ``--task train --max-iter 3`` through the CLI in an NCCL process group
     of world size 1. Each check prints its launches and times beside the
     card's name and power limit.
 17. ranks of a process group, on the one card (two ranks share it over
     gloo, since NCCL refuses two ranks on one GPU): (a) ``--task inference
     --visualize --id --draw-scalebar`` through the CLI in two processes
     started as ``torchrun`` starts them (``MASTER_ADDR``, ``RANK``,
     ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``; each sees
     ``cuda:0`` as its GPU through ``$SMOKE_LOCAL_DEVICES``), each on its
     own copy of phase 12's home: bf16, its rows held to phase 12's
     one-process rows, then, on the first micrograph alone, ``--quantized
     trunk`` held to the same run in an NCCL process group of world size 1
     (exit 0); every image processed
     and every bar read on both ranks, rank 1 writing no result, and each
     kernel's launches on the two ranks (K1, K4, K5, printed per rank) adding
     up to the one-process run's; (b) one float32 training step with
     ``n_model_shards=2`` on two such ranks (data 1 x model 2: the box
     head's fc1 and fc2 split) against phase 16 (c)'s one-process step on
     the same global batch (every weight within RANKS_TOL of the largest
     update, the gap also read in ulps; the losses to 1e-4), 2 K1 and 2 K2
     launches on each rank, which collectives gloo takes on CUDA tensors,
     and the checkpoint rank 0 wrote loaded into one process equal to what
     each rank held. ``python3 -c "import chip_smoke;
     chip_smoke.parallel_only()"`` runs phases 11, 12 (the rows phase 17
     (a) is held to), 16 and 17 alone.
 18. the image codings ``read_image`` reads beside the plain ones: (a) the
     committed fixtures (``tests/data/torch_codings_fixtures.npz``, written
     by ``tools/make_torch_codings_fixtures.py``: FillOrder 2, BigTIFF,
     old-style LZW and cut TIFFs, CCITT RLE, RLEW, Group 3 and Group 4 fax,
     arithmetic-coded, CMYK and YCCK, block-smoothed and lossless JPEG,
     16-bit, bit-field and OS/2 BMP, each beside the array ``cv2.imread``
     returns) decode bit for bit; (b) 2048² files written by
     that tool's numpy writers in worker processes: the arithmetic-
     coded twins (SOF9 and SOF10, gray and 4:2:0, quality 90) of one set of
     quantised coefficients decode bit-equal to its Huffman file; phase 12's
     rasters as FillOrder 2 (raw, LZW, PackBits) and BigTIFF (II and MM,
     strips and LZW tiles) decode to the raster, and a thresholded
     micrograph as Group 4 and 2D Group 3 to its bits, each with its host
     decode seconds (median of 3) beside its plain counterpart's; (c)
     ``--task inference`` through the CLI in its own process, phase 12's
     argv, on phase 12's rasters as BigTIFF LZW tiles, FillOrder 2 LZW
     strips and a FillOrder 2 PackBits BigTIFF: the rows of both CSVs
     byte-equal to phase 12's, as many K1 launches, the preflight naming the
     card. ``python3 -c "import chip_smoke; chip_smoke.codings_only()"``
     runs phase 12's CLI run and phase 18 alone.
 19. the containers ``read_image`` reads beside PNG, TIFF, JPEG and BMP:
     the host's image libraries (``ldconfig -p``, printed, never loaded);
     (a) the committed fixtures (``tests/data/torch_container_fixtures.npz``,
     written by ``tools/make_torch_container_fixtures.py``: PNM, PAM, PFM,
     Sun raster, HDR, GIF, lossless, lossy, alpha and animated WebP,
     libwebp's encoder forms and the numpy VP8 writer's, each beside
     cv2's array or its SHA-256) decode bit for bit; (b) phase 3's first
     raster in each container, written by that tool's numpy writers, and
     a committed 2048² libwebp lossy file: host decode seconds (median of
     3) beside an uncompressed TIFF of the same raster; (c) nine 1024x768
     labelled micrographs (``draw_labelled``), one per container (the
     lossy WebP's bytes committed), through the CLI: ``--task prepare``,
     the first loader batch equal to that of their TIFF twins, K1 and K2
     against their plain versions on one step of a 4-image batch, ``train
     --rcnn 50 --max-iter 4`` (finite losses, 2 K1 + 2 K2 a step) and
     ``evaluate --rcnn 50`` (the JAX evaluator's metric names, 2 K1 a
     test image, K1 against its plain version on its calls).
     ``python3 -c "import chip_smoke; chip_smoke.containers_only()"``
     runs phase 19 alone.
 20. JPEG 2000 (``native/jpeg2000.cpp``, ``ops/jpeg2000.py``) and the
     TIFF forms of C11: the host's machine and image libraries (printed,
     never loaded); (a) the committed fixtures
     (``tests/data/torch_jpeg2000_fixtures.npz``, written by
     ``tools/make_torch_jpeg2000_fixtures.py``: Pillow's, cv2's and the
     numpy writer's JP2 files and codestreams, every code-block style,
     the markers and boxes, cut and damaged copies, and the C11 TIFFs) decode
     bit for bit to cv2's arrays, or raise where cv2 returned None; (b)
     a committed 2048² micrograph, reversible and irreversible: host decode
     seconds (median of 3) beside an uncompressed TIFF of the same pixels;
     (c) six 1024x768 labelled micrographs in JPEG 2000 forms (reversible,
     irreversible, tiled, 16-bit gray, gray and alpha, and a signed one
     that cv2 refuses; the files committed), through the CLI as phase 19
     (c) takes its dataset, the refused frame skipped by every reader.
     ``python3 -c "import chip_smoke; chip_smoke.jpeg2000_only()"`` runs
     phase 20 alone.
 21. Lossless AVIF (``native/av1.cpp``, ``ops/avif.py``) and C12: (a) the
     committed fixtures (``tests/data/torch_avif_fixtures.npz``, written
     by ``tools/make_torch_avif_fixtures.py``: cv2's lossless files at odd
     sizes, 8 to 12 bits, with alpha, the box writer's container forms,
     cut and damaged copies) decode bit for bit to cv2's arrays, raise
     where cv2 returned None, or name the forms the port does not decode;
     the 800 damaged or cut C11 TIFFs of C12 give cv2's outcome; (b) a
     committed 2048² gray micrograph: host decode seconds (median of 3)
     beside an uncompressed TIFF of the same pixels; (c) six 1024x768
     labelled micrographs in lossless forms (BGR, monochrome, 10-bit,
     12-bit, with irot, split across iloc extents; the files committed)
     through the CLI as phase 19 (c) takes its dataset; (d) the lossy
     4:2:0 file cv2 writes at quality 75, which deblocks and applies
     CDEF, and cv2's speed-4 frame with loop restoration decode to cv2's
     arrays, and the AV1 writer's frame with film grain raises
     ``UnsupportedImageError`` naming it.
     ``python3 -c "import chip_smoke; chip_smoke.avif_only()"`` runs
     phase 21 alone.
 22. Lossy and subsampled AVIF (``native/av1.cpp``'s lossy intra path
     with the tables of ``native/av1_tables.h``, its palette mode, intra
     block copy, segmentation, loop filter with delta loop filter levels
     and segmentation's, CDEF and loop restoration, ``ops/avif.py``'s
     libavif colour conversion): (a) one 1024x768 labelled micrograph
     (``draw_labelled``, seed 22, its background flattened) in eighteen
     forms (cv2's quality 95 BGR 4:2:0 and gray,
     quality 99 at 10 and 12 bits, ``tools/av1_writer.py``'s lossless
     4:2:0 BT.601 frame; the deblocked frames: cv2's quality 85 BGR,
     quality 90 at 10 bits BGR and 12 bits gray; the CDEF frames: cv2's
     default quality BGR, quality 75 at 10 bits BGR, the default at 12
     bits gray; the loop restoration frames, with ``avif_textured``'s
     texture: cv2's 8-bit BGR with Wiener luma units, 10-bit BGR, 8- and
     10-bit gray with self-guided luma units, at speeds 4 and 2; cv2's
     BGR frame at speed 4, with intra block copy, and at speed 8, with
     palettes; the writer's lossless 4:2:0 frame with eight segments, all
     lossless, a training frame; the files committed in
     ``tests/data/torch_avif_lossy_fixtures.npz``,
     ``tests/data/torch_avif_cdef_fixtures.npz``,
     ``tests/data/torch_avif_restoration_fixtures.npz``,
     ``tests/data/torch_avif_palette_fixtures.npz``,
     ``tests/data/torch_avif_intrabc_fixtures.npz`` and
     ``tests/data/torch_avif_segmentation_fixtures.npz``) decodes to the
     SHA-256 of cv2's array and near the drawing (the segmented frame to
     it exactly); (b) cv2's quality-75
     frame, which deblocks and applies CDEF, the textured 8-bit gray frame
     with CDEF then restoration, and the committed restoration fixtures
     (cv2's frames at speeds 0-4, the AV1 writer's SWITCHABLE, 4:4:4,
     4:2:2, 12-bit, 128x128-superblock and tiled frames), palette
     fixtures (cv2's frames at speeds 0-8, the writer's 4:2:2, lossy
     4:4:4, 128x128-superblock and tiled ones) and intra block copy
     fixtures (cv2's frames at speeds 0-7, the writer's 4:2:2,
     128x128-superblock and two-tile-row ones) and delta loop filter
     level fixtures (``tests/data/torch_avif_delta_lf_fixtures.npz``: the
     writer's frames in every subsampling at 8, 10 and 12 bits, one delta
     or one per plane and direction, every multiplier, the clamp, levels
     of 0, 128x128 superblocks, tile rows, CDEF and restoration on top,
     reduced_tx_set 1) and segmentation fixtures
     (``tests/data/torch_avif_segmentation_fixtures.npz``: the writer's
     lossy and lossless frames in every subsampling at 8, 10 and 12 bits, a
     lossless segment among lossy ones, ALT_Q under delta q, ALT_LF per
     plane and direction, SKIP, REF_FRAME and GLOBALMV before skip,
     128x128 superblocks, tiles, CDEF, restoration, delta LF, palettes and
     intra block copy on top) decode to cv2's arrays or their SHA-256, the
     writer's frame with a DV into its own undecoded block and its frame
     with a segment id past the last active segment fail where cv2 fails,
     and the writer's frame with film grain raises
     ``UnsupportedImageError`` naming it; (c) committed 2048² BGR rasters:
     the micrograph at quality 95, at 85 (deblocked) and at cv2's default
     quality (deblocked, CDEF), blurred noise at speed 4 (self-guided
     restoration in every plane), and the flattened labelled frame tiled
     at speed 4 (intra block copy), at speed 8 (palettes) and at cv2's
     default speed: host decode seconds (median of 3) beside an
     uncompressed TIFF of the same pixels, and each as a multiple of
     quality 95's; the writer's 1024² 4:2:0 frame with delta LF beside its
     twin with every delta 0, and its 1024² 4:2:0 frame with ALT_Q and
     ALT_LF segments beside its twin from the same seed with segmentation
     off (median of 3, each as a ratio); (d) the eighteen frames through
     the CLI as phase 19 (c) takes its dataset.
     ``python3 -c "import chip_smoke; chip_smoke.avif_lossy_only()"``
     runs phase 22 alone.

Phase 7 runs before phase 6, whose inputs come from a training step,
phases 11, 12, 14, 15, 16 (a, b), 17 (a) and 18 before phase 13, phases 19
to 22 after it, and phases 16 (c) and 17 (b) before phase 10. K1's
``launches`` in the kernel line is the sum of phases 3, 9, 11, 12, 13, 15,
16, 17, 18, 19, 20, 21 and 22, K2's of phases 7, 13, 16, 17, 19, 20, 21 and 22, K4's and
K5's of phase 14's two CLI runs, phase 15's wizard task, phase 16's
two-shard int8 engine and phase 17's ``--quantized trunk`` runs, each
counted from zero over its own run.
Float32 comparisons run with TF32 off for both cuDNN convolutions and
matrix products (``torch.backends.*.allow_tf32 = False``), set below.
Any failure ends the run with a nonzero exit and no result line. The last
lines of standard output are the kernel JSON line, the card line, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402


def _codings_tool():
    """``tools/make_torch_codings_fixtures.py``, loaded by its path: the
    numpy writers of TIFF (FillOrder 2, BigTIFF), CCITT fax, and Huffman-
    and arithmetic-coded JPEG that this script writes its files with (the
    card's host has no image writers)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_torch_codings_fixtures", os.path.join(ROOT, "tools", "make_torch_codings_fixtures.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


codings = _codings_tool()
lzw_encode, packbits_encode, jpeg_encode = codings.lzw_encode, codings.packbits_encode, codings.jpeg_encode


def _containers_tool():
    """``tools/make_torch_container_fixtures.py``, loaded by its path: the
    numpy writers of the PNM family, PAM, PFM, Sun raster, Radiance HDR,
    GIF and lossless WebP that phase 19 writes its files with."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_torch_container_fixtures", os.path.join(ROOT, "tools", "make_torch_container_fixtures.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


containers = _containers_tool()

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
# kernel vs plain, relative to the largest magnitude the result can hold
# (K1: the largest feature, which bounds every bilinear average; K2: the
# largest entry of the plain result), with no absolute floor, so that a
# kernel writing zeros fails however small the values: float32 output
# differs by sums taken in another order (for K2, atomics in a varying
# order), bfloat16 output by at most one rounding step (2^-7 relative) of
# the bf16 result
F32_TOL = 1e-5
BF16_TOL = 1e-2
# |<K1(F),G> - sum_l <F_l,K2(G)_l>| over sum |F_l * K2(G)_l|, sums in f64:
# the pair shares one sample grid, so only f32 rounding separates them
ADJOINT_TOL = 1e-5
# card vs CPU training step (float32, TF32 off): RPN outputs to RPN_RTOL
# of each level's largest entry; losses to 1e-4 relative;
# each parameter's gradient to GRAD_TOL of its largest entry and the
# median tensor to GRAD_TOL_MEDIAN. Random weights put the class logits at
# ~1e2 (a class loss of ~29), so cuDNN's and the CPU's float32 sums differ
# by ~1e-4 of a tensor's largest gradient entry
RPN_RTOL = 1e-4
# proposal boxes the card selects from the CPU's RPN outputs vs the CPU's
PROPOSAL_TOL_PX = 1e-3
LOSS_RTOL = 1e-4
GRAD_TOL = 5e-3
GRAD_TOL_MEDIAN = 5e-4
TRAIN_DIR = os.path.join(ROOT, "build", "chip_smoke_train")
PIPELINE_DIR = os.path.join(ROOT, "build", "chip_smoke_pipeline")
# K3 vs plain: both sum the window in float32, in other orders; relative to
# the sum of |x| over the window
K3_TOL = 1e-5
# card vs CPU pipeline (float32, TF32 off): the share of instances on each
# device with a partner on the other at mask IoU >= PIPE_MIN_IOU, and of
# measurement rows with a partner whose numbers all agree to 1e-3 relative.
# Random weights make the pipeline chaotic at rounding scale, so the two
# devices' CSVs are not identical; the limits sit between the sound
# readings and those of a planted fault (every RoIAlign box on the card
# moved by PIPE_FAULT_PX), which the phase replays on every run and must
# reject. The readings are in PERF.md (Findings)
PIPE_MIN_IOU = 0.95
PIPE_MATCH_SHARE = 0.95
PIPE_ROW_SHARE = 0.9
PIPE_FAULT_PX = 0.25
# the scale bars drawn into phase 9's and 11's micrographs: (label, value in
# micrometres, dark on bright), a BAR_LEN x 4 px bar, glyphs GLYPH_PX tall;
# the read value must be exact and um/px within BAR_RTOL of value / BAR_LEN
BARS = (("500 nm", 0.5, False), ("2 um", 2.0, True), ("1.5 um", 1.5, False))
BAR_LEN = 300
GLYPH_PX = 28
BAR_RTOL = 0.02
# the dataset YAML's scale-bar region (it contains the default region, where
# the bars are drawn) and its one inference override
SMOKE_ROI = {"x_start_factor": 0.68, "y_start_factor": 0.04, "width_factor": 1.0, "height_factor": 0.07}
SMOKE_OVERRIDE = {"postprocessing": {"size_heuristic_sample": 3}}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def time_ms(fn, reps: int = 25) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, each after a
    256 MB write that evicts the 50 MB L2 (the serving path reads its
    pyramid cold)."""
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def roi_work(feats, boxes, valid, batch_idx, out_size, out_dtype):
    """Bytes and float ops this RoIAlign call needs: every feature row its
    valid samples touch read once, the RoI tables read once, the output
    written once; 2 ops per corner weight and channel."""
    from deepemia_tpu_torch.models.roi_align import assign_fpn_levels, sample_grid

    lvl = (assign_fpn_levels(boxes) - 2).long()
    sx, sy = sample_grid(boxes, lvl, out_size, 2, True)
    hs = torch.tensor([f.shape[1] for f in feats], device=boxes.device)
    ws = torch.tensor([f.shape[2] for f in feats], device=boxes.device)
    sizes = hs * ws * feats[0].shape[0]
    base = (torch.cumsum(sizes, 0) - sizes)[lvl] + batch_idx.long() * hs[lvl] * ws[lvl]
    h, w = hs[lvl][:, None], ws[lvl][:, None]

    def corners(s, size):
        i0 = torch.floor(s).long()
        ok = (s >= -1.0) & (s <= size.float())
        lo = torch.minimum(i0.clamp(min=0), size - 1)
        hi = torch.minimum((i0 + 1).clamp(min=0), size - 1)
        return torch.stack([lo, hi], -1), ok

    yc, vy = corners(sy, h)  # [N,P,2]
    xc, vx = corners(sx, w)
    keys = base[:, None, None, None, None] + yc[:, :, :, None, None] * w[:, :, None, None, None] + xc[:, None, None, :, :]
    ok = (vy[:, :, None, None, None] & vx[:, None, None, :, None]) & valid[:, None, None, None, None]
    ok = ok.expand_as(keys)
    c = feats[0].shape[3]
    rows = int(torch.unique(keys[ok]).numel())
    samples = int((vy[:, :, None] & vx[:, None, :] & valid[:, None, None]).sum())
    n = boxes.shape[0]
    out_bytes = n * out_size * out_size * c * torch.empty((), dtype=out_dtype).element_size()
    in_bytes = rows * c * feats[0].element_size() + n * (16 + 4 + 4 + 1)
    flops = samples * 4 * c * 2
    bound_s = max((in_bytes + out_bytes) / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)
    by = "bytes" if (in_bytes + out_bytes) / HBM_BYTES_PER_S >= flops / F32_FLOPS_PER_S else "operations"
    return bound_s * 1e3, by


def compare_roi_align(tag, feats, boxes, valid, batch_idx, out_size, dtype, reps=25, adaptive=True, timed=True):
    """Kernel vs plain on the same inputs; returns the record of one row
    (with ``timed=False`` only its error, and nothing is timed)."""
    from deepemia_tpu_torch.kernels.roi_align import roi_align_cuda
    from deepemia_tpu_torch.models.roi_align import assign_fpn_levels, multilevel_roi_align

    levels = (assign_fpn_levels(boxes) - 2).contiguous()
    bidx = batch_idx.to(torch.int32).contiguous()

    def kernel():
        return roi_align_cuda(feats, boxes, levels, bidx, valid, output_size=out_size,
                              sampling_ratio=2, adaptive_ratio=adaptive, out_dtype=dtype)

    def plain():
        fd = dict(zip(("p2", "p3", "p4", "p5"), feats))
        return multilevel_roi_align(fd, boxes, out_size, 2, adaptive_ratio=adaptive, valid=valid,
                                    batch_idx=bidx, out_dtype=dtype)

    got = kernel()
    torch.cuda.synchronize()
    ref = plain()
    err = float((got.float() - ref.float()).abs().max())
    scale = max(float(f.float().abs().max()) for f in feats)
    tol = (F32_TOL if dtype == torch.float32 else BF16_TOL) * scale
    zeros = bool((got[~valid] == 0).all())
    line = (f"roi_align {tag}: N={boxes.shape[0]} valid={int(valid.sum())} out={out_size} "
            f"{str(dtype).split('.')[-1]} max_abs_err={err:.3g} tol={tol:.3g} invalid_rows_zero={zeros}")
    if not (err <= tol and zeros and math.isfinite(err)):
        raise AssertionError(f"{line}: kernel disagrees with plain")
    if not timed:
        print(line, flush=True)
        return dict(err=err)
    k_ms = time_ms(kernel, reps)
    p_ms = time_ms(plain, max(3, reps // 5))
    bound_ms, by = roi_work(feats, boxes, valid, bidx, out_size, dtype)
    print(f"{line} kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} bound_ms={bound_ms:.4f} ({by}) "
          f"share_of_bound={bound_ms / k_ms:.3f}", flush=True)
    return dict(err=err, ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=by)


def synthetic_rois(n, image, frac_valid, gen):
    ctr = torch.rand(n, 2, generator=gen) * image * 1.1 - 0.05 * image
    wh = torch.exp(torch.empty(n, 2).uniform_(math.log(4), math.log(700), generator=gen))
    boxes = torch.cat([ctr - wh / 2, ctr + wh / 2], 1)
    valid = torch.rand(n, generator=gen) < frac_valid
    boxes[~valid] = 0.0
    return boxes.cuda().contiguous(), valid.cuda()


def edge_rois():
    """RoIs on the pyramid of a 2048² whole-image pass (p2..p5 of 512..64
    cells) that stress the kernels' tap tables and footprints: elongated
    700x4 and 4x700 px boxes (p2, 175 x 1 cells), p5 boxes of 19-64 cells
    (wider than 7 and 14), boxes past the image edge and past [-1, size]
    (two of them wholly outside, whose samples all weigh zero). Every fifth
    row is invalid for K1."""
    rows = []
    for y in (10.0, 1000.0, 2040.0):
        rows += [[100.0, y, 800.0, y + 4.0], [y / 2, 300.0, y / 2 + 4.0, 1000.0]]
    rows += [[0.0, 0.0, 2048.0, 2048.0], [100.0, 200.0, 1900.0, 1300.0], [300.0, 300.0, 1000.0, 1000.0],
             [1024.0, 0.0, 2048.0, 600.0]]
    rows += [[-300.0, 100.0, 200.0, 400.0], [1900.0, -250.0, 2300.0, 150.0], [-40.0, -40.0, 60.0, 60.0],
             [2000.0, 2000.0, 2100.0, 2100.0], [-500.0, -500.0, -100.0, -100.0], [2200.0, 100.0, 2600.0, 500.0]]
    boxes = torch.tensor(rows, dtype=torch.float32, device="cuda")
    valid = torch.ones(len(rows), dtype=torch.bool, device="cuda")
    valid[::5] = False
    return boxes, valid


# output sizes of the edge cases: 7 and 14 take the kernels' unrolled
# instances, 5 their generic one
EDGE_OUTS = (5, 7, 14)


def edge_pyramid(dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(1, s, s, 256, device="cuda", generator=gen).to(dtype) for s in (512, 256, 128, 64)]


def phase_kernel_vs_plain():
    from deepemia_tpu_torch.kernels.roi_align import counter, roi_align_cuda

    gen = torch.Generator().manual_seed(1)
    shapes = [256, 128, 64, 32]  # p2..p5 of one 1024² model input
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        feats = [torch.randn(1, s, s, 256, generator=gen).to("cuda", dtype) for s in shapes]
        for n, out, frac in ((1000, 7, 0.5), (100, 14, 1.0)):
            boxes, valid = synthetic_rois(n, 1024.0, frac, gen)
            bidx = torch.zeros(n, dtype=torch.int32, device="cuda")
            rows[(n, dtype)] = compare_roi_align(f"tile {n}x{out}", feats, boxes, valid, bidx, out, dtype)
    # edge cases: elongated, wide p5, past the edges, all invalid, N = 0
    boxes, valid = edge_rois()
    bidx = torch.zeros(boxes.shape[0], dtype=torch.int32, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        feats = edge_pyramid(dtype, seed=2)
        for out in EDGE_OUTS:
            for tag, v in (("edge cases", valid), ("edge cases, all invalid", torch.zeros_like(valid))):
                rows[(tag, out, dtype)] = compare_roi_align(f"{tag} {out}x{out}", feats, boxes, v, bidx, out,
                                                            dtype, timed=False)
            before = counter.launches
            got = roi_align_cuda(feats, boxes[:0], bidx[:0], bidx[:0], valid[:0], out, 2, True, dtype)
            torch.cuda.synchronize()
            assert got.shape == (0, out, out, 256) and counter.launches == before, "N = 0"
            print(f"roi_align edge cases N=0 {out}x{out} {str(dtype).split('.')[-1]}: empty result, "
                  f"nothing launched", flush=True)
    return rows


def synthetic_micrograph(size: int, seed: int) -> np.ndarray:
    """A grey micrograph: noisy background and ~300 dark round particles."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    yy, xx = torch.meshgrid(
        torch.arange(size, device="cuda", dtype=torch.float32),
        torch.arange(size, device="cuda", dtype=torch.float32),
        indexing="ij",
    )
    img = 170.0 + 12.0 * torch.randn(size, size, device="cuda", generator=gen)
    ctr = torch.rand(300, 2, device="cuda", generator=gen) * size
    rad = 6.0 + 40.0 * torch.rand(300, device="cuda", generator=gen)
    for (cy, cx), r in zip(ctr.tolist(), rad.tolist()):
        y0, y1 = max(int(cy - 3 * r), 0), min(int(cy + 3 * r) + 1, size)
        x0, x1 = max(int(cx - 3 * r), 0), min(int(cx + 3 * r) + 1, size)
        d2 = (yy[y0:y1, x0:x1] - cy) ** 2 + (xx[y0:y1, x0:x1] - cx) ** 2
        img[y0:y1, x0:x1] -= 90.0 * torch.exp(-d2 / (2 * (0.6 * r) ** 2))
    gray = img.clamp(0, 255).round().to(torch.uint8)
    return gray[..., None].expand(-1, -1, 3).contiguous().cpu().numpy()


def sane_geometry(model):
    """Random weights decode degenerate boxes. Zero the box regression and
    scale the RPN deltas (|d| ~ 4e2 at random weights, so most proposals
    clip to nothing) and the mask logits (|l| ~ 3e1) down to trained
    magnitudes, as the parity tests do (tests/test_torch_heads.py)."""
    with torch.no_grad():
        model.roi_heads.box_predictor.bbox_pred.weight.zero_()
        model.roi_heads.box_predictor.bbox_pred.bias.zero_()
        model.proposal_generator["rpn_head"].anchor_deltas.weight.mul_(1e-2)
        model.roi_heads.mask_head.predictor.weight.mul_(1e-1)


def check_instances(inst, capacity):
    assert inst.boxes.shape == (capacity, 4) and inst.mask_probs.shape == (capacity, 28, 28)
    for t in (inst.boxes, inst.scores, inst.mask_probs):
        assert bool(torch.isfinite(t).all()), "non-finite detections"
    v = inst.valid
    assert bool(((inst.mask_probs[v] >= 0) & (inst.mask_probs[v] <= 1)).all())
    assert bool((inst.boxes[v][:, 2:] >= inst.boxes[v][:, :2]).all())


def phase_slice(images):
    from deepemia_tpu_torch.inference.engine import TileEngine, class_settings_from_config
    from deepemia_tpu_torch.kernels.roi_align import counter
    from deepemia_tpu_torch.models.mask_rcnn import build_model

    model = build_model("R50", num_classes=2, use_bf16=True, device="cuda", seed=0)
    sane_geometry(model)
    engine = TileEngine(model)
    settings = class_settings_from_config({}, 2, device="cuda")
    counter.launches = 0
    secs = []
    for i, img in enumerate(images):
        (inst, quality), dt = sync_time(lambda img=img: engine.infer(img, settings))
        check_instances(inst, engine.capacity)
        secs.append(dt)
        print(
            f"slice image {i}: {img.shape[0]}x{img.shape[1]} valid_detections={int(inst.valid.sum())} "
            f"quality={float(quality):.4f} seconds={dt:.4f}",
            flush=True,
        )
    launches = counter.launches
    n_tiles = 25
    expected = len(images) * 2 * (1 + math.ceil(n_tiles / engine.tile_batch))
    print(
        f"slice: roi_align launches={launches} (expected {expected}: box + mask stage for the "
        f"whole-image pass and each {engine.tile_batch}-tile batch) "
        f"seconds_per_image={secs} first_image_includes_warmup=True",
        flush=True,
    )
    assert launches > 0, "the main path launched no RoIAlign kernel"
    assert launches == expected, (launches, expected)
    return model, engine, launches


def capture_tile_batch(model, engine, image):
    """RoIAlign inputs of the first tile batch of ``image``, as the engine
    builds them (outside the counted run)."""
    import deepemia_tpu_torch.models.heads as heads_mod
    from deepemia_tpu_torch.ops import tiles as tile_ops
    from deepemia_tpu_torch.ops.image import resize_image

    calls = []
    real = heads_mod.roi_align_dispatch

    def record(features, boxes, **kw):
        calls.append((features, boxes, kw))
        return real(features, boxes, **kw)

    img = torch.as_tensor(image).cuda()
    grid = tile_ops.compute_tile_grid(img.shape[0], img.shape[1], engine.tile_size, engine.overlap_ratio)
    tiles = tile_ops.extract_tiles(img, grid)[: engine.tile_batch].float()
    ts_up = int(round(engine.tile_size * engine.upscale_factor))
    heads_mod.roi_align_dispatch = record
    try:
        feats = model.features_batched(resize_image(tiles, ts_up, ts_up))
        model.detect_batched(feats, (ts_up, ts_up))
    finally:
        heads_mod.roi_align_dispatch = real
    assert len(calls) == 2
    return calls


def phase_captured(calls):
    """Kernel vs plain on the recorded inputs: in the path's output dtype
    (the timed rows) and with float32 output, which holds the f32 sums to
    F32_TOL."""
    rows = []
    for (features, boxes, kw), tag in zip(calls, ("box", "mask")):
        feats = [features[k] for k in ("p2", "p3", "p4", "p5")]
        args = (feats, boxes, kw["valid"], kw["batch_idx"], kw["output_size"])
        rows.append(compare_roi_align(f"captured {tag} stage", *args, kw["out_dtype"]))
        compare_roi_align(f"captured {tag} stage, f32 output", *args, torch.float32, reps=3)
    return rows


def phase_stage_times(model, engine, image):
    """Seconds of each stage of one 16-tile batch and of the image-level
    steps, each ended by a synchronize."""
    from deepemia_tpu_torch.inference.detections import concat_instances, dedup_by_mask_iou
    from deepemia_tpu_torch.inference.engine import apply_class_thresholds, class_settings_from_config
    from deepemia_tpu_torch.models import anchors as anchor_lib
    from deepemia_tpu_torch.models.heads import fast_rcnn_inference_batched
    from deepemia_tpu_torch.models.rpn import select_proposals_batched
    from deepemia_tpu_torch.ops import tiles as tile_ops
    from deepemia_tpu_torch.ops.image import resize_image

    st = {}
    img = torch.as_tensor(image).cuda()
    grid = tile_ops.compute_tile_grid(img.shape[0], img.shape[1], engine.tile_size, engine.overlap_ratio)
    tiles = tile_ops.extract_tiles(img, grid)[: engine.tile_batch].float()
    ts_up = int(round(engine.tile_size * engine.upscale_factor))
    hw = (ts_up, ts_up)
    rh = model.roi_heads
    for rep in range(2):  # the second pass is the one kept (the first warms up)
        ups, st["upscale"] = sync_time(lambda: resize_image(tiles, ts_up, ts_up))
        feats, st["trunk_fpn"] = sync_time(lambda: model.features_batched(ups))
        (logits, regs), st["rpn_head"] = sync_time(lambda: model.proposal_generator["rpn_head"](feats))
        anchors = anchor_lib.all_anchors({k: (v.shape[2], v.shape[3]) for k, v in feats.items()}, "cuda")
        props, st["select_proposals_nms"] = sync_time(
            lambda: select_proposals_batched(logits, regs, anchors, hw))
        nhwc = {k: feats[k].permute(0, 2, 3, 1) for k in ("p2", "p3", "p4", "p5")}
        pooled, st["roi_align_box"] = sync_time(lambda: rh._pool(nhwc, props.boxes, props.valid, 7))
        (sc, dl), st["box_head"] = sync_time(lambda: rh.box_predictor(rh.box_head(pooled)))
        b = props.boxes.shape[0]
        (boxes, scores, classes, valid), st["fast_rcnn_nms"] = sync_time(
            lambda: fast_rcnn_inference_batched(sc.reshape(b, -1, sc.shape[-1]), dl.reshape(b, -1, dl.shape[-1]),
                                                props.boxes, props.valid, hw, 0.05))
        pooled_m, st["roi_align_mask"] = sync_time(lambda: rh._pool(nhwc, boxes, valid, 14))
        _, st["mask_head"] = sync_time(lambda: rh.mask_head(pooled_m))
        full, st["whole_image_pass"] = sync_time(lambda: engine._forward(img))
        merged, st["merge_thresholds"] = sync_time(lambda: apply_class_thresholds(
            concat_instances([full], engine.capacity), class_settings_from_config({}, 2, device="cuda"),
            torch.ones((), device="cuda")))
        _, st["mask_iou_dedup_nms"] = sync_time(
            lambda: dedup_by_mask_iou(merged, tuple(img.shape[:2]), engine.dedup_iou, stride=8))
    print("stage seconds (one 16-tile batch of 1024² inputs; image-level steps on 2048²): "
          + json.dumps({k: round(v, 6) for k, v in st.items()}), flush=True)


def phase_small_reference():
    """A 128² image, 64 px tiles x2 (9 tiles) + whole-image pass, float32:
    the engine on the card (CUDA kernel) against the engine on the CPU
    (plain RoIAlign), same weights."""
    from deepemia_tpu_torch.inference.engine import TileEngine, class_settings_from_config
    from deepemia_tpu_torch.models.mask_rcnn import build_model

    cpu_model = build_model("R50", num_classes=2, use_bf16=False, device="cpu", seed=3)
    sane_geometry(cpu_model)
    gpu_model = build_model("R50", num_classes=2, use_bf16=False, device="cuda", seed=3)
    gpu_model.load_state_dict(cpu_model.state_dict(), strict=True)
    img = (np.random.default_rng(5).random((128, 128, 3)) * 255).astype(np.uint8)
    kw = dict(tile_size=64, tile_batch=4)
    cfg = {"class_specific_settings": {"class_0": {"confidence_threshold": 0.3}}}
    ref, _ = TileEngine(cpu_model, device="cpu", **kw).infer(img, class_settings_from_config(cfg, 2))
    got, _ = TileEngine(gpu_model, device="cuda", **kw).infer(img, class_settings_from_config(cfg, 2, device="cuda"))
    got = [t.cpu() for t in got]
    rv, gv = ref.valid, got[3]
    print(f"small reference: valid cpu={int(rv.sum())} gpu={int(gv.sum())}", flush=True)
    assert int(rv.sum()) > 0 and bool((rv == gv).all()), "valid sets differ"
    db = float((got[0][rv] - ref.boxes[rv]).abs().max())
    ds = float((got[1][rv] - ref.scores[rv]).abs().max())
    dm = float((got[4][rv] - ref.mask_probs[rv]).abs().max())
    print(f"small reference: max |d box|={db:.3g} px |d score|={ds:.3g} |d mask|={dm:.3g}", flush=True)
    assert bool((got[2][rv] == ref.classes[rv]).all())
    assert db <= 1e-2 and ds <= 1e-4 and dm <= 1e-3, (db, ds, dm)


def synthetic_train_batches(n_batches, seed, size=512, gmax=64, ims=2):
    """Training batches in the loader's format: grey micrographs (noisy
    background, 10-40 bright disks and ellipses each), GT boxes as the
    masks' tight bounds, 2 classes, masks rasterized in numpy and
    bit-packed as the loader sends them."""
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(n_batches):
        img = np.clip(rng.normal(90.0, 15.0, (ims, size, size)), 0, 255)
        boxes = np.zeros((ims, gmax, 4), np.float32)
        classes = np.zeros((ims, gmax), np.int32)
        valid = np.zeros((ims, gmax), bool)
        masks = np.zeros((ims, gmax, size, size), bool)
        for i in range(ims):
            for j in range(min(int(rng.integers(10, 41)), gmax)):
                cy, cx = rng.uniform(20, size - 20, 2)
                ry, rx = rng.uniform(6, 30, 2) if rng.random() < 0.5 else (rng.uniform(6, 30),) * 2
                th = rng.uniform(0, np.pi)
                r = int(max(ry, rx)) + 1
                y0, y1 = max(int(cy) - r, 0), min(int(cy) + r + 1, size)
                x0, x1 = max(int(cx) - r, 0), min(int(cx) + r + 1, size)
                yy, xx = np.mgrid[y0:y1, x0:x1]
                u = (xx - cx) * np.cos(th) + (yy - cy) * np.sin(th)
                v = -(xx - cx) * np.sin(th) + (yy - cy) * np.cos(th)
                win = (u / rx) ** 2 + (v / ry) ** 2 <= 1.0
                if not win.any():
                    continue
                masks[i, j, y0:y1, x0:x1] = win
                img[i, y0:y1, x0:x1][win] = rng.uniform(160, 230)
                ys, xs = np.nonzero(win)
                boxes[i, j] = [x0 + xs.min(), y0 + ys.min(), x0 + xs.max() + 1, y0 + ys.max() + 1]
                classes[i, j] = int(rng.integers(0, 2))
                valid[i, j] = True
        image = np.repeat(img.round().astype(np.uint8)[..., None], 3, axis=-1)
        batches.append(dict(image=image, gt_boxes=boxes, gt_classes=classes, gt_valid=valid,
                            gt_masks=np.packbits(masks, axis=-1)))
    return batches


def check_first_update(model, opt, before, lr, cfg):
    """The card's first optimizer step against torch's SGD on the CPU,
    applied to the same weights and the same gradients: from scratch every
    parameter trains, at the schedule's rate at count 0 (Detectron2's
    warmup factor 1e-3 times the base rate), with momentum 0.9 and weight
    decay 1e-4. Each updated weight must match to 2 float32 steps of its
    magnitude, so a tensor the card left in place fails wherever the CPU
    moved it."""
    params = dict(model.named_parameters())
    n_opt = sum(len(group["params"]) for group in opt.param_groups)
    assert n_opt == len(params), f"the optimizer holds {n_opt} of {len(params)} parameter tensors"
    assert math.isclose(lr, cfg.base_lr * 1e-3, rel_tol=1e-9), (lr, cfg.base_lr)
    missing = [n for n, p in params.items() if p.grad is None]
    assert not missing, f"no gradient for {missing[:5]}"
    ref = {n: before[n].cpu().clone().requires_grad_() for n in params}
    for n, p in params.items():
        ref[n].grad = p.grad.detach().cpu()
    sgd = torch.optim.SGD(list(ref.values()), lr=lr, momentum=0.9, weight_decay=1e-4)
    sgd.step()
    moved_card = moved_ref = 0
    for n, p in params.items():
        got, want, p0 = p.detach().cpu(), ref[n].detach(), before[n].cpu()
        moved_card += not torch.equal(got, p0)
        moved_ref += not torch.equal(want, p0)
        excess = (got - want).abs() - 2.0**-22 * torch.maximum(p0.abs(), want.abs())
        assert float(excess.max()) <= 0.0, f"{n}: the card's update differs from SGD on the CPU"
    print(f"train step 1 update: lr={lr:.6g}, {n_opt} tensors in the optimizer, all with gradients; "
          f"moved on the card {moved_card}, by SGD on the CPU {moved_ref}; every weight within "
          f"2 float32 steps of the CPU's update", flush=True)
    assert moved_ref > 0, "SGD on the CPU moved no tensor"


def phase_train(batches):
    """``train_on_batches()`` from scratch to step 6 (checkpoints at 3 and 6), then a
    second call to step 8 that resumes at 6. Every train_step is wrapped
    to time it and to count its kernel launches."""
    import shutil

    from deepemia_tpu_torch.kernels.roi_align import bwd_counter, counter
    from deepemia_tpu_torch.models.mask_rcnn import build_train_model
    from deepemia_tpu_torch.train import trainer as trainer_mod

    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    cfg = trainer_mod.TrainConfig(checkpoint_every=3, log_every=1)
    steps = []
    real = trainer_mod.train_step

    def timed(model, opt, *args, **kw):
        first = not steps
        if first:
            before = {n: p.detach().clone() for n, p in model.named_parameters()}
            lr = opt.param_groups[0]["lr"]
        k1, k2 = counter.launches, bwd_counter.launches
        metrics, dt = sync_time(lambda: real(model, opt, *args, **kw))
        steps.append(dict(metrics, seconds=dt, k1=counter.launches - k1, k2=bwd_counter.launches - k2))
        if first:
            check_first_update(model, opt, before, lr, cfg)
        return metrics

    torch.cuda.reset_peak_memory_stats()
    counter.launches = bwd_counter.launches = 0
    trainer_mod.train_step = timed
    try:
        trainer_mod.train_on_batches(batches, 2, TRAIN_DIR, cfg, max_steps_override=6)
        first = sorted(os.listdir(os.path.join(TRAIN_DIR, "ckpts")))
        final, _ = trainer_mod.train_on_batches(batches, 2, TRAIN_DIR, cfg, max_steps_override=8)
    finally:
        trainer_mod.train_step = real
    launches = {"roi_align_fwd": counter.launches, "roi_align_bwd": bwd_counter.launches}
    peak = torch.cuda.max_memory_allocated()
    second = sorted(os.listdir(os.path.join(TRAIN_DIR, "ckpts")))
    for i, st in enumerate(steps):
        print("train step {}: ".format(i + 1) + json.dumps({k: round(v, 6) for k, v in st.items()}), flush=True)
    assert first == ["step_00000003.pt", "step_00000006.pt"], first
    assert len(steps) == 8 and second == ["step_00000006.pt", "step_00000008.pt"], (len(steps), second)
    for st in steps:
        assert all(math.isfinite(st[k]) for k in ("rpn_cls", "rpn_loc", "cls", "box", "mask", "total")), st
        assert st["k1"] == 2 and st["k2"] == 2, st
    assert launches == {"roi_align_fwd": 16, "roi_align_bwd": 16}, launches

    start = build_train_model("R50", 2, device="cpu", seed=cfg.seed)
    trainer_mod.zero_residual_norms(start)
    after = torch.load(final, map_location="cpu")["model"]
    moved = sum(not torch.equal(v, after[k]) for k, v in start.state_dict().items())
    # at the schedule's warmup rates (~1e-7) an update of a small gradient
    # is below one float32 step of its weight, so not every tensor moves
    print(f"train: {moved} of {len(after)} parameter tensors moved in 8 steps", flush=True)
    assert moved > 0
    steady = float(np.median([st["seconds"] for st in steps[2:]]))
    print(
        f"train: steady seconds/step={steady:.6f} (median of steps 3-8; R50-FPN, 2 x 512², bf16) "
        f"first_step_seconds={steps[0]['seconds']:.4f} resumed_first_step_seconds={steps[6]['seconds']:.4f} "
        f"peak_memory_allocated_GB={peak / 1e9:.4f} launches={launches} (expected 2 + 2 per step)",
        flush=True,
    )
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    return launches, steady


def capture_train_step(batch):
    """The RoIAlign inputs (features, boxes, image indices) and cotangents
    of one training step as ``train_on_batches()`` runs it (outside the counted run)."""
    import deepemia_tpu_torch.models.heads as heads_mod
    from deepemia_tpu_torch.models.mask_rcnn import build_train_model
    from deepemia_tpu_torch.train import trainer as trainer_mod

    cfg = trainer_mod.TrainConfig(ims_per_batch=len(batch["image"]))
    model = build_train_model("R50", 2, device="cuda", seed=cfg.seed)
    trainer_mod.zero_residual_norms(model)
    opt, sched = trainer_mod.make_optimizer(model.parameters(), cfg.base_lr, 8, cfg.warmup_iters, cfg.gamma)
    calls = []
    real = heads_mod.roi_align_dispatch

    def record(features, boxes, **kw):
        out = real(features, boxes, **kw)
        call = dict(feats=[features[k].detach() for k in ("p2", "p3", "p4", "p5")], boxes=boxes.detach().float(),
                    bidx=kw["batch_idx"].to(torch.int32), out=kw["output_size"])
        out.register_hook(lambda g: call.__setitem__("g", g.detach().contiguous()))
        calls.append(call)
        return out

    heads_mod.roi_align_dispatch = record
    try:
        trainer_mod.train_step(model, opt, sched, batch, cfg,
                               trainer_mod.image_generators(cfg.seed, 0, range(len(batch["image"])), "cuda"))
    finally:
        heads_mod.roi_align_dispatch = real
    torch.cuda.synchronize()
    assert [c["out"] for c in calls] == [7, 14] and all("g" in c for c in calls)
    return calls


def bwd_work(g, boxes, shapes, out_dtype):
    """Bytes and float ops of the function one K2 call computes: the
    cotangent and the RoI tables read once, the feature cotangents written
    once in ``out_dtype`` (the zeros of untouched cells are part of that
    write); 2 ops per corner weight and channel of every valid sample.
    Also returns the milliseconds at the memory rate of this design's own
    extra traffic: its float32 accumulators zeroed and written, and for a
    bf16 result read back before the cast."""
    from deepemia_tpu_torch.models.roi_align import assign_fpn_levels, sample_grid

    n, out, c = g.shape[0], g.shape[1], g.shape[3]
    lvl = (assign_fpn_levels(boxes) - 2).long()
    sx, sy = sample_grid(boxes, lvl, out, 2, True)
    hs = torch.tensor([sh[1] for sh in shapes], device=boxes.device)[lvl][:, None]
    ws = torch.tensor([sh[2] for sh in shapes], device=boxes.device)[lvl][:, None]
    vy = (sy >= -1.0) & (sy <= hs.float())
    vx = (sx >= -1.0) & (sx <= ws.float())
    samples = int((vy[:, :, None] & vx[:, None, :]).sum())
    total = sum(b * h * w for b, h, w in shapes) * c
    out_bytes = total * torch.empty((), dtype=out_dtype).element_size()
    nbytes = g.numel() * g.element_size() + n * (16 + 4 + 4) + out_bytes
    acc_bytes = 2 * 4 * total + (4 * total if out_dtype == torch.bfloat16 else 0)
    if out_dtype == torch.float32:
        acc_bytes -= out_bytes  # the accumulators are the result
    flops = samples * 4 * c * 2
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations"), acc_bytes / HBM_BYTES_PER_S * 1e3


def compare_backward(tag, g, boxes, levels, bidx, shapes, dtype):
    """K2 against its plain version on the same inputs, tolerance relative
    to the plain result's max |dF| with no floor -> (kernel, plain, err,
    line); raises where they disagree."""
    from deepemia_tpu_torch.kernels.roi_align import roi_align_backward_cuda
    from deepemia_tpu_torch.models.roi_align import multilevel_roi_align_backward

    def kernel():
        return roi_align_backward_cuda(g, boxes, levels, bidx, shapes, 2, True, dtype)

    def plain():
        return multilevel_roi_align_backward(g, boxes, shapes, bidx, 2, True, dtype)

    got = kernel()
    torch.cuda.synchronize()
    ref = plain()
    err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, ref))
    peak = max(float(b.float().abs().max()) for b in ref)
    tol = (F32_TOL if dtype == torch.float32 else BF16_TOL) * peak
    line = (f"roi_align_bwd {tag}: N={boxes.shape[0]} out={g.shape[1]} {str(dtype).split('.')[-1]} "
            f"max_abs_err={err:.3g} tol={tol:.3g} (max |dF| {peak:.4g})")
    if not (peak > 0 and err <= tol and math.isfinite(err)):
        raise AssertionError(f"{line}: kernel disagrees with plain")
    return kernel, plain, err, line


def check_adjoint(tag, f32, boxes, levels, bidx, g32):
    """<K1(F),G> = sum_l <F_l, K2(G)_l> on the card, float32 kernels,
    float64 sums, to ADJOINT_TOL of sum |F_l * K2(G)_l|."""
    from deepemia_tpu_torch.kernels.roi_align import roi_align_backward_cuda, roi_align_cuda

    shapes = [tuple(f.shape[:3]) for f in f32]
    fwd = roi_align_cuda(f32, boxes, levels, bidx, None, g32.shape[1], 2, True, torch.float32)
    bwd = roi_align_backward_cuda(g32, boxes, levels, bidx, shapes, 2, True, torch.float32)
    lhs = float((fwd.double() * g32.double()).sum())
    rhs = sum(float((a.double() * b.double()).sum()) for a, b in zip(f32, bwd))
    mag = sum(float((a.double() * b.double()).abs().sum()) for a, b in zip(f32, bwd))
    rel = abs(lhs - rhs) / max(mag, 1e-30)
    print(f"adjoint {tag}: <K1(F),G>={lhs:.9g} sum<F,K2(G)>={rhs:.9g} rel={rel:.3g} tol={ADJOINT_TOL}", flush=True)
    assert rel <= ADJOINT_TOL, (tag, rel)


def phase_backward(calls):
    """K2 against its plain version on the captured inputs and on a seeded
    unit-scale cotangent (bf16, the path's dtype, and float32), the
    adjoint identity, and times."""
    from deepemia_tpu_torch.models.roi_align import assign_fpn_levels

    rows = []
    for call, tag in zip(calls, ("box", "mask")):
        boxes, bidx, out = call["boxes"], call["bidx"], call["out"]
        levels = (assign_fpn_levels(boxes) - 2).contiguous()
        shapes = [tuple(f.shape[:3]) for f in call["feats"]]
        # the step's own cotangent (timed), then a seeded unit-scale one on
        # the same RoIs, each in the path's dtype (bf16: the bf16 load and
        # the cast to bf16) and in float32
        gen = torch.Generator(device="cuda").manual_seed(3)
        g_unit = torch.randn(call["g"].shape, device="cuda", generator=gen)
        for source, g_src in (("captured", call["g"]), ("unit", g_unit)):
            for dtype in (torch.bfloat16, torch.float32):
                g = g_src.to(dtype)
                kernel, plain, err, line = compare_backward(f"train {tag} stage, {source} cotangent", g, boxes,
                                                            levels, bidx, shapes, dtype)
                if source == "unit":
                    print(line, flush=True)
                    rows[-1]["err"] = max(rows[-1]["err"], err)
                    continue
                k_ms = time_ms(kernel, 25 if dtype == torch.bfloat16 else 5)
                p_ms = time_ms(plain, 5 if dtype == torch.bfloat16 else 3)
                bound_ms, by, extra_ms = bwd_work(g, boxes, shapes, dtype)
                print(f"{line} kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} bound_ms={bound_ms:.4f} ({by}) "
                      f"share_of_bound={bound_ms / k_ms:.3f} accumulator_traffic_ms={extra_ms:.4f}", flush=True)
                if dtype == torch.bfloat16:
                    rows.append(dict(err=err, ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=by))

        check_adjoint(f"{tag} stage", [f.float().contiguous() for f in call["feats"]], boxes, levels, bidx,
                      call["g"].float())
        valid = torch.ones(boxes.shape[0], dtype=torch.bool, device="cuda")
        compare_roi_align(f"train {tag} stage (K1)", call["feats"], boxes, valid, bidx, out,
                          call["feats"][0].dtype, reps=25)
    return rows


def phase_backward_edges():
    """K2 against its plain version on the edge-case RoIs of phase 2 (all
    rows; K2 has no valid mask), a seeded unit cotangent, bf16 and float32,
    with the adjoint identity; N = 0 gives zeros; an all-invalid set
    through ``RoIAlignFunction`` on the card gives zero rows and zero
    feature gradients."""
    from deepemia_tpu_torch.kernels.roi_align import roi_align_backward_cuda
    from deepemia_tpu_torch.models.roi_align import assign_fpn_levels, roi_align_dispatch

    gen = torch.Generator().manual_seed(4)
    boxes, valid = edge_rois()
    n = boxes.shape[0]
    levels = (assign_fpn_levels(boxes) - 2).contiguous()
    bidx = torch.zeros(n, dtype=torch.int32, device="cuda")
    f32 = edge_pyramid(torch.float32, seed=5)
    shapes = [tuple(f.shape[:3]) for f in f32]
    for out in EDGE_OUTS:
        g_unit = torch.randn(n, out, out, 256, generator=gen).cuda()
        for dtype in (torch.bfloat16, torch.float32):
            print(compare_backward(f"edge cases {out}x{out}", g_unit.to(dtype), boxes, levels, bidx, shapes,
                                   dtype)[3], flush=True)
        check_adjoint(f"edge cases {out}x{out}", f32, boxes, levels, bidx, g_unit)
        empty = roi_align_backward_cuda(g_unit[:0], boxes[:0], levels[:0], bidx[:0], shapes, 2, True, torch.float32)
        assert all(int(t.count_nonzero()) == 0 for t in empty), "N = 0 must give zero gradients"
        feats = {k: f.clone().requires_grad_(True) for k, f in zip(("p2", "p3", "p4", "p5"), f32)}
        pooled = roi_align_dispatch(feats, boxes, out, adaptive_ratio=True, valid=torch.zeros_like(valid),
                                    batch_idx=bidx)
        (pooled * g_unit).sum().backward()
        zero = int(pooled.count_nonzero()) == 0 and all(int(f.grad.count_nonzero()) == 0 for f in feats.values())
        print(f"roi_align_bwd edge cases {out}x{out}: N=0 gives zeros; all-invalid set through RoIAlignFunction "
              f"gives zero rows and zero feature gradients: {zero}", flush=True)
        assert zero


def phase_train_reference():
    """One float32 training step at 128² on the card (K1, K2) and on the
    CPU (plain RoIAlign and adjoint): same weights, batch and draws, and
    the CPU's proposals handed to the card's loss. Objectness scores of
    random weights sit closer together than the two devices' rounding
    differences, so the top-k cuts and NMS may keep another proposal on
    each device; how many differ is printed. The card's selection is held
    to the CPU's on its own: the RPN outputs of the two devices must agree
    to RPN_RTOL, and the card, given the CPU's RPN outputs, must select the
    CPU's proposals (same validity, boxes within PROPOSAL_TOL_PX)."""
    from deepemia_tpu_torch.models.mask_rcnn import build_train_model
    from deepemia_tpu_torch.train import losses as losses_mod
    from deepemia_tpu_torch.train import trainer as trainer_mod

    cfg = trainer_mod.TrainConfig(train_size=128, max_instances=16, use_bf16=False)
    batch = synthetic_train_batches(1, seed=11, size=128, gmax=16)[0]
    cpu = build_train_model("R50", 2, device="cpu", seed=3)
    sane_geometry(cpu)
    gpu = build_train_model("R50", 2, device="cuda", seed=3)
    gpu.load_state_dict(cpu.state_dict())
    n_anchors = sum(3 * (128 // st) ** 2 for st in (4, 8, 16, 32, 64))
    n_rois = 1000 + 16  # post-NMS proposals + the appended GT rows
    gen = torch.Generator().manual_seed(5)
    draws = [losses_mod.Draws(*(torch.rand(n, generator=gen) for n in (n_anchors, n_anchors, n_rois, n_rois)))
             for _ in range(2)]
    out, props, rpn = {}, {}, {}
    real = losses_mod.select_proposals_batched

    def select(logits, regs, anchors, hw, **kw):
        p = real(logits, regs, anchors, hw, **kw)
        dev = p.boxes.device.type
        props[dev] = p
        rpn[dev] = ({k: v.detach() for k, v in logits.items()}, {k: v.detach() for k, v in regs.items()},
                    anchors, hw, kw)
        return p if dev == "cpu" else type(p)(*(t.to(dev) for t in props["cpu"]))

    losses_mod.select_proposals_batched = select
    try:
        for dev, model in (("cpu", cpu), ("cuda", gpu)):
            images, gt = trainer_mod.batch_to_device(batch, dev, cfg)
            d = [losses_mod.Draws(*(t.to(dev) for t in dr)) for dr in draws]
            losses = losses_mod.maskrcnn_loss(model, images, gt, draws=d)
            losses["total"].backward()
            out[dev] = ({k: float(v.detach()) for k, v in losses.items()},
                        {n: p.grad.detach().cpu() for n, p in model.named_parameters()})
    finally:
        losses_mod.select_proposals_batched = real
    pc, pg = props["cpu"], type(props["cuda"])(*(t.cpu() for t in props["cuda"]))
    both = pc.valid & pg.valid
    print(f"train reference proposals, each device's own: valid cpu={int(pc.valid.sum())} "
          f"gpu={int(pg.valid.sum())} rows differing in validity={int((pc.valid != pg.valid).sum())} "
          f"rows moved > {PROPOSAL_TOL_PX} px="
          f"{int(((pc.boxes - pg.boxes).abs().amax(-1) > PROPOSAL_TOL_PX)[both].sum())}", flush=True)
    (lc, rc, ac, hw, kw), (lg, rg) = rpn["cpu"], rpn["cuda"][:2]
    for name, c_maps, g_maps in (("objectness", lc, lg), ("deltas", rc, rg)):
        for lv in c_maps:
            gap = float((g_maps[lv].cpu() - c_maps[lv]).abs().max()) / float(c_maps[lv].abs().max())
            print(f"train reference rpn {name} {lv}: max |card - cpu| / max |cpu| = {gap:.3g} "
                  f"(tol {RPN_RTOL})", flush=True)
            assert gap <= RPN_RTOL, (name, lv, gap)
    on_card = real({k: v.cuda() for k, v in lc.items()}, {k: v.cuda() for k, v in rc.items()},
                   {k: v.cuda() for k, v in ac.items()}, hw, **kw)
    sv, sb = on_card.valid.cpu(), on_card.boxes.cpu()
    moved = float((sb - pc.boxes).abs().amax(-1)[pc.valid].max())
    print(f"train reference proposals, the card's selection from the CPU's RPN outputs: valid "
          f"{int(sv.sum())} (cpu {int(pc.valid.sum())}), rows differing in validity "
          f"{int((sv != pc.valid).sum())}, max |d box| {moved:.3g} px (tol {PROPOSAL_TOL_PX})", flush=True)
    assert bool((sv == pc.valid).all()) and moved <= PROPOSAL_TOL_PX, "the card selects other proposals"
    (ref, ref_g), (got, got_g) = out["cpu"], out["cuda"]
    print("train reference losses cpu: " + json.dumps(ref), flush=True)
    print("train reference losses gpu: " + json.dumps(got), flush=True)
    for k in ref:
        assert math.isfinite(got[k]) and abs(got[k] - ref[k]) <= LOSS_RTOL * abs(ref[k]), (k, got[k], ref[k])
    errs = {}
    for n, r in ref_g.items():
        scale = float(r.abs().max())
        errs[n] = float((got_g[n] - r).abs().max()) / scale if scale > 0 else float((got_g[n]).abs().max())
    worst = sorted(errs.items(), key=lambda kv: kv[1])[-3:]
    median = float(np.median(list(errs.values())))
    print(f"train reference gradients: {len(errs)} tensors, err / max |grad| median={median:.3g} "
          f"(tol {GRAD_TOL_MEDIAN}) worst={worst} (tol {GRAD_TOL})", flush=True)
    assert all(e <= GRAD_TOL for e in errs.values()) and median <= GRAD_TOL_MEDIAN, worst


def phase_train_profile(batch):
    """Device time of two steady training steps by kernel (torch.profiler,
    CUDA activity), and the device's busy share of their wall time. The
    profiler's host-side recording lengthens the wall time, so the busy
    share is a lower bound."""
    from torch.profiler import ProfilerActivity, profile

    from deepemia_tpu_torch.models.mask_rcnn import build_train_model
    from deepemia_tpu_torch.train import trainer as trainer_mod

    cfg = trainer_mod.TrainConfig(ims_per_batch=len(batch["image"]))
    model = build_train_model("R50", 2, device="cuda", seed=cfg.seed)
    trainer_mod.zero_residual_norms(model)
    opt, sched = trainer_mod.make_optimizer(model.parameters(), cfg.base_lr, 8, cfg.warmup_iters, cfg.gamma)

    def step(i):
        trainer_mod.train_step(model, opt, sched, batch, cfg,
                               trainer_mod.image_generators(cfg.seed, i, range(len(batch["image"])), "cuda"))

    for i in range(3):
        step(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(3, 5):
            step(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (kernels, copies, sets): the host ops that
    # launched them, and annotated ranges, carry the same time again
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
            and not e.is_user_annotation]
    assert rows, "the profiler recorded no device time"
    busy_s = sum(t for _, t, _ in rows) / 1e6
    print(f"train profile: 2 steps wall={wall:.4f} s device_busy={busy_s:.4f} s "
          f"busy_share={busy_s / wall:.3f} (profiler on)", flush=True)
    for key, t, count in sorted(rows, key=lambda r: -r[1])[:15]:
        print(f"train profile: {t / 2e3:9.4f} ms/step  x{count // 2:<5d} {key[:110]}", flush=True)
    print(f"train profile: {len(rows)} device event kinds, {sum(c for _, _, c in rows) // 2} device events per step",
          flush=True)


# the encodings phase 12 writes its micrographs in: (name, TIFF compression, predictor)
CLI_ENCODINGS = (("LZW", 5, 1), ("Deflate, predictor 2", 8, 2), ("PackBits", 32773, 1))


def write_tiff(path: str, gray: np.ndarray, compression: int = 1, predictor: int = 1, rows_per_strip=None,
               colormap=None) -> None:
    """An 8-bit gray TIFF: header, strips of ``rows_per_strip`` rows (one
    strip by default) in ``compression`` (1 none, 5 LZW, 8 Deflate, 32773
    PackBits) with ``predictor`` (2: horizontal differencing), the IFD and
    the strip tables after it; with a ``colormap`` ([3,256] 16-bit
    entries), an 8-bit palette TIFF of the same indices."""
    import struct
    import zlib

    h, w = gray.shape
    rps = rows_per_strip or h
    g = np.ascontiguousarray(gray, np.uint8)
    encode = {1: bytes, 5: lzw_encode, 8: zlib.compress, 32773: packbits_encode}[compression]
    strips = []
    for y in range(0, h, rps):
        s = g[y : y + rps]
        if predictor == 2:
            s = np.concatenate([s[:, :1], np.diff(s, axis=1)], axis=1)  # uint8 wraps modulo 256
        strips.append(encode(s.tobytes()))
    body, offsets = bytearray(), []
    for b in strips:
        offsets.append(8 + len(body))
        body += b + b"\0" * (len(b) & 1)
    ifd_at = 8 + len(body)
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [8]), (259, 3, [compression]),
            (262, 3, [1 if colormap is None else 3]), (273, 4, offsets), (277, 3, [1]), (278, 4, [rps]),
            (279, 4, [len(b) for b in strips])]
    if predictor != 1:
        tags.append((317, 3, [predictor]))
    if colormap is not None:
        tags.append((320, 3, [int(v) for v in np.asarray(colormap).ravel()]))
    tail_at = ifd_at + 2 + 12 * len(tags) + 4
    ifd, tail = bytearray(struct.pack("<H", len(tags))), bytearray()
    for tag, typ, vals in tags:
        fmt = "H" if typ == 3 else "I"
        payload = struct.pack(f"<{len(vals)}{fmt}", *vals)
        if len(payload) <= 4:
            ifd += struct.pack("<HHI", tag, typ, len(vals)) + payload.ljust(4, b"\0")
        else:
            ifd += struct.pack("<HHII", tag, typ, len(vals), tail_at + len(tail))
            tail += payload
    ifd += struct.pack("<I", 0)
    with open(path, "wb") as f:
        f.write(b"II*\x00" + struct.pack("<I", ifd_at) + bytes(body) + bytes(ifd) + bytes(tail))


def draw_scale_bar(gray: np.ndarray, label: str, dark_on_bright: bool) -> np.ndarray:
    """``gray`` with SMOKE_ROI (which holds the default scale-bar region: x
    from 0.7 of the width, rows 0.05..0.10 of the height) cleared to a flat
    background, a BAR_LEN x 4 px bar in the default region and ``label``
    centred above the bar, its glyphs (DejaVu Sans, GLYPH_PX tall) pasted
    from the reader's atlas on one baseline."""
    from deepemia_tpu_torch.inference.scalebar import _atlas

    h, w = gray.shape
    out = gray.copy()
    x0, y0 = int(w * 0.7), int(h * 0.05)
    bg, fg = (225, 25) if dark_on_bright else (30, 230)
    cx, cy = int(w * SMOKE_ROI["x_start_factor"]), int(h * SMOKE_ROI["y_start_factor"])
    out[cy : cy + int(h * SMOKE_ROI["height_factor"]), cx:] = bg
    sans = dict(_atlas()[GLYPH_PX][2::4])  # per glyph: simplex, duplex, sans, serif
    widths = [GLYPH_PX // 2 + 4 if ch == " " else sans[ch].shape[1] for ch in label]
    bar_x, bar_y = x0 + 130, y0 + GLYPH_PX + 24
    x = bar_x + (BAR_LEN - sum(widths) - 4 * (len(label) - 1)) // 2
    base = y0 + 10 + GLYPH_PX
    for ch, wd in zip(label, widths):
        if ch != " ":
            t = sans[ch].astype(np.float32) / 255.0
            region = out[base - t.shape[0] : base, x : x + wd].astype(np.float32)
            out[base - t.shape[0] : base, x : x + wd] = np.round(region + (fg - region) * t).astype(np.uint8)
        x += wd + 4
    out[bar_y : bar_y + 4, bar_x : bar_x + BAR_LEN] = fg
    return out


def pipeline_home(name: str, model, images, r101=None, bars=False):
    """A dataset home under ``PIPELINE_DIR/name``: the category file, the
    model's float32 state dict as ``model_final_r50.pt`` (and ``r101``'s as
    ``model_final_r101.pt``), the images as TIFF, with the BARS drawn when
    ``bars``. -> (default config of the home, split_dir, image folder,
    output folder)."""
    import shutil

    from deepemia_tpu_torch.config.config import default_config

    home = os.path.join(PIPELINE_DIR, name)
    shutil.rmtree(home, ignore_errors=True)
    cfg = default_config(home)
    folder = os.path.join(home, "INFERENCE")
    os.makedirs(folder)
    with open(cfg["paths"]["category_json"], "w") as f:
        json.dump({"smoke": [folder, folder, ["particle", "pore"]]}, f)
    for depth, net in (("R50", model), ("R101", r101)):
        if net is None:
            continue
        ckpt = os.path.join(cfg["paths"]["split_dir"], "smoke", f"rcnn_{depth.lower()}")
        os.makedirs(ckpt)
        sd = {k: v.detach().float().cpu() for k, v in net.state_dict().items()}
        torch.save({"model": sd, "backbone": depth, "num_classes": 2},
                   os.path.join(ckpt, f"model_final_{depth.lower()}.pt"))
    for i, img in enumerate(images):
        gray = img[..., 0]
        if bars:
            gray = draw_scale_bar(gray, BARS[i][0], BARS[i][2])
        write_tiff(os.path.join(folder, f"micrograph_{i}.tif"), gray)
    return cfg, cfg["paths"]["split_dir"], folder, os.path.join(home, "out")


def check_scale_bars(res, meas, names):
    """Every drawn bar read: the value exactly (in the reader's result and
    in the CSV's scale-bar column), um/px within BAR_RTOL of value / BAR_LEN."""
    for i, name in enumerate(names):
        label, value_um, _ = BARS[i]
        psum, um_pix = res["scale_bars"][name]
        expected = value_um / BAR_LEN
        print(f"scale bar {name}: drawn {label!r} -> read {psum!r}, um_pix {um_pix:.6g} "
              f"(expected {expected:.6g})", flush=True)
        assert psum == label.split()[0], (name, psum, label)
        assert abs(um_pix - expected) <= BAR_RTOL * expected, (name, um_pix, expected)
        assert {r[-2] for r in meas[1:] if r[-1] == name} == {psum}, name


def read_csv(path):
    import csv

    csv.field_size_limit(1 << 30)  # the RLE of a mask over most of a 2048² image
    with open(path) as f:
        return list(csv.reader(f))


def smoke_config(home: str):
    """The configuration branch of phase 9: with PyYAML, write the dataset
    YAML (SMOKE_ROI, SMOKE_OVERRIDE) and return None, so that the store
    reads ``<home>/config``; without it, check that ``get_config`` names the
    file it cannot read and return ``validate_config(default_config(home))``."""
    from deepemia_tpu_torch.config.config import default_config, get_config
    from deepemia_tpu_torch.config.schema import validate_config
    from deepemia_tpu_torch.utils.exceptions import ConfigurationError

    try:
        import yaml
    except ImportError:
        yaml = None
    print(f"config: PyYAML importable={yaml is not None}", flush=True)
    if yaml is not None:
        d = os.path.join(home, "config", "datasets")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "smoke.yaml"), "w") as f:
            yaml.safe_dump({"scale_bar_roi": SMOKE_ROI, "inference_overrides": SMOKE_OVERRIDE}, f)
        print("config: branch = run_inference('smoke', split_dir) with no config: the store's config.yaml "
              "and config/datasets/smoke.yaml", flush=True)
        return None
    try:
        get_config("smoke")
    except ConfigurationError as e:
        assert "config.yaml" in str(e) and "yaml" in str(e), e
        print(f"config: get_config('smoke') raised ConfigurationError: {e}", flush=True)
    else:
        raise AssertionError("get_config read a YAML file without PyYAML")
    print("config: branch = InferencePipeline under validate_config(default_config(home))", flush=True)
    return validate_config(default_config(home))


class ObservedPipelines:
    """Within the block, every ``InferencePipeline`` that
    ``run_inference`` builds is kept in ``.made``, with its ``_infer_one``
    wrapped by ``wrap``."""

    def __init__(self, wrap):
        import deepemia_tpu_torch.inference.pipeline as pipeline_mod

        self.mod, self.wrap, self.made = pipeline_mod, wrap, []

    def __enter__(self):
        base, made, wrap = self.mod.InferencePipeline, self.made, self.wrap

        class Observed(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                self._infer_one = wrap(self._infer_one)
                made.append(self)

        self.base, self.mod.InferencePipeline = base, Observed
        return self

    def __exit__(self, *exc):
        self.mod.InferencePipeline = self.base


class StageLog:
    """Within the block, every ``StageTimers`` that the pipeline makes also
    appends each stage's (name, seconds) to ``.calls``, in order."""

    def __enter__(self):
        import contextlib

        import deepemia_tpu_torch.inference.pipeline as pipeline_mod

        base, calls = pipeline_mod.StageTimers, []

        class Logged(base):
            @contextlib.contextmanager
            def time(self, name):
                before = self.totals[name]
                with super().time(name):
                    yield
                calls.append((name, self.totals[name] - before))

        self.mod, self.base, self.calls = pipeline_mod, base, calls
        pipeline_mod.StageTimers = Logged
        return self

    def __exit__(self, *exc):
        self.mod.StageTimers = self.base

    def steady(self):
        """Stage seconds of each image after the first: the calls from one
        ``decode`` to the next, without the run's closing RLE file write."""
        per_image = []
        for name, sec in self.calls[:-1]:
            if name == "decode":
                per_image.append({})
            if per_image:
                per_image[-1][name] = round(per_image[-1].get(name, 0.0) + sec, 4)
        return per_image[1:]


def phase_pipeline(model, images):
    """The pipeline on three 2048² micrographs at full width, default
    configuration, each with a drawn scale bar; every bar must be read,
    every multilevel RoIAlign must launch K1, and K1 must agree with the
    plain RoIAlign at every pyramid shape the run gave it."""
    import deepemia_tpu_torch.models.heads as heads_mod
    from deepemia_tpu_torch.inference.pipeline import InferencePipeline, run_inference
    from deepemia_tpu_torch.kernels.roi_align import counter
    from deepemia_tpu_torch.ops.rle import rle_decode

    _, split_dir, folder, out = pipeline_home("full", model, images, bars=True)
    home = os.path.join(PIPELINE_DIR, "full")
    counts, calls, shapes = {}, [], {}
    real_dispatch = heads_mod.roi_align_dispatch

    def wrap(real_infer):
        def infer(image, timers):
            inst, q = real_infer(image, timers)
            counts[len(counts)] = int(inst.valid.sum())
            return inst, q

        return infer

    def dispatch(features, boxes, **kw):
        # the first call of each pyramid shape and stage, held against the
        # plain version after the counted run
        calls.append(int(boxes.shape[0]))
        key = (tuple(features["p2"].shape), kw["output_size"])
        if boxes.shape[0] and key not in shapes:
            shapes[key] = ([features[k] for k in ("p2", "p3", "p4", "p5")], boxes.clone(),
                           {k: v.clone() if torch.is_tensor(v) else v for k, v in kw.items()})
        return real_dispatch(features, boxes, **kw)

    saved_home = os.environ.get("DEEPEMIA_TPU_HOME")
    os.environ["DEEPEMIA_TPU_HOME"] = home
    try:
        cfg = smoke_config(home)
        with ObservedPipelines(wrap) as seen, StageLog() as stage_log:
            heads_mod.roi_align_dispatch = dispatch
            counter.launches = 0
            if cfg is None:
                res = run_inference("smoke", split_dir, image_folder=folder, output_dir=out, visualize=False)
            else:
                pipe = InferencePipeline("smoke", split_dir, out, cfg)
                pipe._infer_one = wrap(pipe._infer_one)
                res = pipe.run(folder, visualize=False)
            launches = counter.launches
    finally:
        heads_mod.roi_align_dispatch = real_dispatch
        if saved_home is None:
            os.environ.pop("DEEPEMIA_TPU_HOME", None)
        else:
            os.environ["DEEPEMIA_TPU_HOME"] = saved_home
    if cfg is None:
        (pipe,) = seen.made
        assert pipe.config["scale_bar_rois"]["smoke"] == SMOKE_ROI, pipe.config["scale_bar_rois"]
        assert pipe.size_heuristic_sample == SMOKE_OVERRIDE["postprocessing"]["size_heuristic_sample"]
        print(f"config: the dataset YAML reached the pipeline: scale_bar_rois.smoke={SMOKE_ROI}, "
              f"size_heuristic_sample={pipe.size_heuristic_sample}", flush=True)
    assert pipe.use_multiscale and pipe.postproc_enabled and not pipe.use_ensemble
    assert next(pipe.engine.model.parameters()).dtype == torch.bfloat16
    names = sorted(os.listdir(folder))
    assert res["processed"] == names and not res["failed"], res
    rle = read_csv(res["rle_csv"])[1:]
    meas = read_csv(res["measurements_csv"])
    assert meas[0][0] == "Instance_ID" and len(meas) > 1
    check_scale_bars(res, meas, names)
    h, w = images[0].shape[:2]
    for i, name in enumerate(names):
        rows = [r for r in rle if r[0] == name]
        assert len(rows) == counts[i] > 0, (name, len(rows), counts[i])
        for _, enc in rows:
            vals = [int(t) for t in enc.split()]
            starts, lengths = vals[0::2], vals[1::2]
            assert all(s >= 1 and s + n - 1 <= h * w for s, n in zip(starts, lengths)), name
            assert rle_decode(vals, (h, w)).sum() == sum(lengths), name
        ids = {int(r[0].rsplit("_", 1)[1]) for r in meas[1:] if r[-1] == name}
        assert ids and ids <= set(range(1, counts[i] + 1)), name
    rois = sum(1 for n in calls if n > 0)
    print(f"pipeline: images={len(names)} valid_instances={[counts[i] for i in range(len(names))]} "
          f"rle_rows={len(rle)} measurement_rows={len(meas) - 1} multilevel_roi_align_calls={len(calls)} "
          f"(with RoIs {rois}) roi_align_fwd launches={launches}", flush=True)
    assert launches > 0 and launches == rois, "a multilevel RoIAlign of the pipeline did not launch K1"
    errs, timed = hold_captured(shapes, "pipeline", timed=True)
    print(f"pipeline: K1 at the {len(timed)} captured shapes, one launch each: kernel ms "
          f"{sum(r['ms'] for r in timed):.4f}, bound ms {sum(r['bound_ms'] for r in timed):.4f}", flush=True)
    print(f"pipeline: K1 held against the plain RoIAlign at {len(shapes)} pyramid shapes and stages", flush=True)
    shapes.clear()
    print(f"pipeline: size heuristic valid={pipe._heuristic_valid} small classes={sorted(pipe.small_classes)} "
          f"classes needing the upscale={sorted(pipe.upscale_classes)} -> tile upscale "
          f"{'x1 (native tiles)' if pipe._heuristic_valid and not pipe.upscale_classes else 'configured'}", flush=True)
    secs = res["seconds_per_image"]
    print(f"pipeline: seconds_per_image first={secs[0]:.4f} steady={secs[1:]} ({h}x{w}, bf16, default config; "
          f"size heuristic before the loop {res['stages']['size_heuristic']['total_s']:.4f} s)", flush=True)
    print("pipeline stage seconds: " + json.dumps(
        {k: {"total_s": round(v["total_s"], 6), "count": v["count"]} for k, v in res["stages"].items()}), flush=True)
    print(f"pipeline: steady stage seconds per image {json.dumps(stage_log.steady())}", flush=True)
    sb = res["stages"]["scalebar"]
    print(f"pipeline: scalebar stage seconds per image {sb['total_s'] / sb['count']:.4f} "
          f"(host, {sb['count']} images of {h}x{w}, the first loads the glyph atlas)", flush=True)
    scalebar_steady_seconds(folder, pipe)
    return launches, errs


def hold_captured(shapes, label, timed=False):
    """K1 against the plain RoIAlign on captured calls ({(p2 shape, output
    size): (levels, boxes, keywords)}), in the path's dtype (timed per
    launch when ``timed``) and with float32 output -> (errors, timed
    rows)."""
    errs, rows = [], []
    for ((b, hp, wp, _), out_size), (feats, boxes, kw) in sorted(shapes.items()):
        args = (feats, boxes, kw["valid"], kw["batch_idx"], out_size)
        tag = f"{label} {b} x {4 * hp}x{4 * wp} input, {'box' if out_size == 7 else 'mask'} stage"
        for dtype in dict.fromkeys((kw["out_dtype"], torch.float32)):
            row = compare_roi_align(tag, *args, dtype, reps=10, adaptive=kw["adaptive_ratio"],
                                    timed=timed and dtype == kw["out_dtype"])
            errs.append(row["err"])
            if "ms" in row:
                rows.append(row)
    return errs, rows


def scalebar_steady_seconds(folder, pipe):
    """The reader's seconds per image on the run's decoded images, the
    atlas loaded and the run's template caches warm (second of two passes)."""
    from deepemia_tpu_torch.inference.scalebar import detect_scale_bar
    from deepemia_tpu_torch.ops.image import read_image

    imgs = [read_image(os.path.join(folder, n)) for n in sorted(os.listdir(folder))]
    for _ in range(2):
        secs = []
        for img in imgs:
            t0 = time.perf_counter()
            detect_scale_bar(img, pipe.config, pipe.dataset_name, return_debug=True)
            secs.append(time.perf_counter() - t0)
    print(f"pipeline: scalebar steady seconds per image {json.dumps([round(x, 4) for x in secs])} "
          f"(host, {imgs[0].shape[0]}x{imgs[0].shape[1]})", flush=True)


def phase_ensemble(model, images):
    """The default configuration's ensemble on phase 9's images: a seeded
    R101-FPN checkpoint beside the R50 one; both members must run on every
    image, every multilevel RoIAlign with RoIs must launch K1 in each
    member, and K1 must agree with the plain RoIAlign at the R101 member's
    first shape of each stage. -> (K1 launches of the run, errors, its RLE
    and measurement rows without their headers)."""
    import deepemia_tpu_torch.models.heads as heads_mod
    from deepemia_tpu_torch.config.schema import validate_config
    from deepemia_tpu_torch.inference.pipeline import InferencePipeline
    from deepemia_tpu_torch.kernels.roi_align import counter
    from deepemia_tpu_torch.models.mask_rcnn import build_model
    from deepemia_tpu_torch.ops import tiles as tile_ops
    from deepemia_tpu_torch.ops.image import resize_image

    r101 = build_model("R101", num_classes=2, use_bf16=True, device="cuda", seed=1)
    sane_geometry(r101)
    cfg, split_dir, folder, out = pipeline_home("ensemble", model, images, r101=r101, bars=True)
    cfg = validate_config(cfg)
    es = cfg["inference_settings"]["ensemble_settings"]
    assert es["enabled"] and es["small_classes_only"], es
    pipe = InferencePipeline("smoke", split_dir, out, cfg)
    assert pipe.use_ensemble and [n for n, _, _ in pipe.engines] == ["R101", "R50"], pipe.engines
    assert len(pipe.engines[0][1].model.backbone.bottom_up.res4) == 23
    assert all(next(e.model.parameters()).dtype == torch.bfloat16 for _, e, _ in pipe.engines)

    member = {"name": None}
    calls = {"R101": [], "R50": []}
    shapes = {}
    real_dispatch = heads_mod.roi_align_dispatch

    def tracked(name, infer):
        def run(*a, **kw):
            member["name"] = name
            try:
                return infer(*a, **kw)
            finally:
                member["name"] = None

        return run

    for name, engine, _ in pipe.engines:
        engine.infer = tracked(name, engine.infer)

    def dispatch(features, boxes, **kw):
        calls[member["name"]].append(int(boxes.shape[0]))
        key = kw["output_size"]
        if member["name"] == "R101" and boxes.shape[0] and key not in shapes:
            shapes[key] = ([features[k] for k in ("p2", "p3", "p4", "p5")], boxes.clone(),
                           {k: v.clone() if torch.is_tensor(v) else v for k, v in kw.items()})
        return real_dispatch(features, boxes, **kw)

    counter.launches = 0
    heads_mod.roi_align_dispatch = dispatch
    try:
        with StageLog() as stage_log:
            res = pipe.run(folder, visualize=False)
    finally:
        heads_mod.roi_align_dispatch = real_dispatch
    launches = counter.launches
    names = sorted(os.listdir(folder))
    assert res["processed"] == names and not res["failed"], res
    assert res["members"] == {n: ["R101", "R50"] for n in names}, res["members"]
    meas = read_csv(res["measurements_csv"])
    rle = read_csv(res["rle_csv"])[1:]
    check_scale_bars(res, meas, names)
    with_rois = {m: sum(1 for n in c if n > 0) for m, c in calls.items()}
    print(f"ensemble: members {res['members'][names[0]]} on every image; multilevel_roi_align calls "
          f"{ {m: len(c) for m, c in calls.items()} } (with RoIs {with_rois}) roi_align_fwd launches={launches}",
          flush=True)
    assert min(with_rois.values()) > 0 and launches == sum(with_rois.values()), \
        "a multilevel RoIAlign of the ensemble did not launch K1"
    errs = []
    for out_size, (feats, boxes, kw) in sorted(shapes.items()):
        tag = f"ensemble R101 {tuple(feats[0].shape)} p2, {'box' if out_size == 7 else 'mask'} stage"
        for dtype in dict.fromkeys((kw["out_dtype"], torch.float32)):
            row = compare_roi_align(tag, feats, boxes, kw["valid"], kw["batch_idx"], out_size, dtype,
                                    adaptive=kw["adaptive_ratio"], timed=False)
            errs.append(row["err"])
    assert sorted(shapes) == [7, 14], sorted(shapes)
    per_image = {n: sum(1 for r in rle if r[0] == n) for n in names}
    secs = res["seconds_per_image"]
    print(f"ensemble: merged instances per image {per_image}; seconds_per_image first={secs[0]:.4f} "
          f"steady={[round(x, 4) for x in secs[1:]]} ({images[0].shape[0]}x{images[0].shape[1]}, bf16, "
          f"R101 + R50, default config)", flush=True)
    print("ensemble stage seconds: " + json.dumps(
        {k: {"total_s": round(v["total_s"], 6), "count": v["count"]} for k, v in res["stages"].items()}), flush=True)
    print(f"ensemble: steady stage seconds per image {json.dumps(stage_log.steady())}", flush=True)

    # R101's trunk + FPN on one 16-tile batch of 1024² inputs (512 px tiles, x2)
    engine = pipe.engines[0][1]
    img = torch.as_tensor(images[0]).cuda()
    grid = tile_ops.compute_tile_grid(img.shape[0], img.shape[1], engine.tile_size, engine.overlap_ratio)
    ts_up = int(round(engine.tile_size * engine.upscale_factor))
    ups = resize_image(tile_ops.extract_tiles(img, grid)[: engine.tile_batch].float(), ts_up, ts_up)
    r50 = pipe.engines[1][1].model
    times = {}
    for rep_i in range(3):  # the last pass is kept
        for tag, net in (("R101", engine.model), ("R50", r50)):
            _, times[tag] = sync_time(lambda net=net: net.features_batched(ups))
    print(f"ensemble: trunk + FPN seconds per {engine.tile_batch}-tile batch of {ts_up}² inputs, bf16: "
          f"R101 {times['R101']:.4f}, R50 {times['R50']:.4f}", flush=True)
    return launches, errs, (rle, meas[1:])


def ensemble_only():
    """Phases 1 and 11 alone (phase 3's R50 weights rebuilt from their seed)."""
    from deepemia_tpu_torch.kernels import _build
    from deepemia_tpu_torch.models.mask_rcnn import build_model

    import shutil

    print(f"card: {card_line()}", flush=True)
    _build.build(["roi_align_fwd"])
    with torch.inference_mode():
        model = build_model("R50", num_classes=2, use_bf16=True, device="cuda", seed=0)
        sane_geometry(model)
        images = [synthetic_micrograph(2048, seed) for seed in range(3)]
        try:
            phase_ensemble(model, images)
        finally:
            shutil.rmtree(PIPELINE_DIR, ignore_errors=True)


def best_match_share(score):
    """[N,M] agreement scores in [0,1] -> the share of rows and of columns
    whose best partner scores 1 (both directions)."""
    if score.size == 0:
        return 0.0, 0.0
    return float((score.max(axis=1) >= 1).mean()), float((score.max(axis=0) >= 1).mean())


def pipeline_csvs(model, img, name, device, backend="host"):
    """Both CSVs' rows (headers dropped) of one image through the pipeline
    in float32, measured by ``backend``."""
    from deepemia_tpu_torch.inference.pipeline import InferencePipeline

    cfg, split_dir, folder, out = pipeline_home(name, model, [img])
    cfg["performance"]["measurement_backend"] = backend
    pipe = InferencePipeline("smoke", split_dir, out, cfg, use_bf16=False, device=device)
    res = pipe.run(folder, visualize=False)
    assert not res["failed"], res
    return read_csv(res["rle_csv"])[1:], read_csv(res["measurements_csv"])[1:]


def mask_iou(rle_a, rle_b):
    """[Na, Nb] mask IoU of two lists of RLE rows (1-based run starts and
    lengths over one image's flat pixel order), counted on the runs: only
    pairs whose first-to-last pixel spans overlap are compared, identical
    strings score 1, two empty masks 1."""

    def runs(row):
        v = np.array(row[1].split(), np.int64).reshape(-1, 2)
        span = (int(v[0, 0]), int(v[-1, 0] + v[-1, 1])) if v.size else (0, 0)
        return v, span

    def pixels(v):
        offsets = np.repeat(v[:, 0] - np.r_[0, np.cumsum(v[:-1, 1])], v[:, 1])
        return np.arange(int(v[:, 1].sum()), dtype=np.int64) + offsets

    ra, rb = [runs(r) for r in rle_a], [runs(r) for r in rle_b]
    iou = np.zeros((len(ra), len(rb)))
    for i, (va, (a0, a1)) in enumerate(ra):
        pa = None
        for j, (vb, (b0, b1)) in enumerate(rb):
            if not va.size and not vb.size:
                iou[i, j] = 1.0
            elif rle_a[i][1] == rle_b[j][1]:
                iou[i, j] = 1.0
            elif a0 < b1 and b0 < a1:
                pa = pixels(va) if pa is None else pa
                pb = pixels(vb)
                inter = np.intersect1d(pa, pb, assume_unique=True).size
                iou[i, j] = inter / (pa.size + pb.size - inter)
    return iou


def csv_agreement(rle_g, meas_g, rle_c, meas_c):
    """Instances matched by mask IoU >= PIPE_MIN_IOU and measurement rows
    matched by value (same class, every number to 1e-3 relative), each
    side's share with a partner on the other; identical RLE strings."""
    inst_g, inst_c = best_match_share(mask_iou(rle_g, rle_c) >= PIPE_MIN_IOU)

    def numbers(rows):
        return np.array([[float(v) for v in r[3:15]] for r in rows]), np.array([r[2] for r in rows])

    (vg, cg), (vc, cc) = numbers(meas_g), numbers(meas_c)
    rel = np.abs(vg[:, None, :] - vc[None, :, :]) / np.maximum(np.abs(vc[None, :, :]), 1e-9)
    rows_g, rows_c = best_match_share((rel.max(axis=2) <= 1e-3) & (cg[:, None] == cc[None, :]))
    cpu_strings = {r[1] for r in rle_c}
    return dict(n_card=len(rle_g), n_cpu=len(rle_c), identical=sum(r[1] in cpu_strings for r in rle_g),
                inst=min(inst_g, inst_c), rows_card=len(meas_g), rows_cpu=len(meas_c), rows=min(rows_g, rows_c))


def phase_pipeline_reference(model):
    """One 256² image through the pipeline in float32 on the card and on
    the CPU (plain RoIAlign), same weights and default configuration.
    Borderline instances (a score, size gate or IoU within rounding of its
    threshold) may differ between the two devices and shift the rows after
    them, so instances are matched by mask IoU and measurement rows by
    value, not by position. Then the card again with a planted fault (every
    RoIAlign box moved by PIPE_FAULT_PX), which the limits must reject."""
    import deepemia_tpu_torch.models.heads as heads_mod

    img = synthetic_micrograph(256, seed=7)
    rle_c, meas_c = pipeline_csvs(model, img, "ref_cpu", "cpu")
    rle_g, meas_g = pipeline_csvs(model, img, "ref_cuda", "cuda")
    a = csv_agreement(rle_g, meas_g, rle_c, meas_c)
    print("pipeline reference 256² f32: " + json.dumps(a), flush=True)
    assert min(a["n_card"], a["n_cpu"], a["rows_card"], a["rows_cpu"]) > 0
    assert a["inst"] >= PIPE_MATCH_SHARE and a["rows"] >= PIPE_ROW_SHARE, a
    real = heads_mod.roi_align_dispatch
    heads_mod.roi_align_dispatch = lambda features, boxes, **kw: real(features, boxes + PIPE_FAULT_PX, **kw)
    try:
        rle_f, meas_f = pipeline_csvs(model, img, "ref_fault", "cuda")
    finally:
        heads_mod.roi_align_dispatch = real
    f = csv_agreement(rle_f, meas_f, rle_c, meas_c)
    print(f"pipeline reference 256² f32, card with RoIAlign boxes moved by {PIPE_FAULT_PX} px: " + json.dumps(f),
          flush=True)
    assert f["inst"] < PIPE_MATCH_SHARE or f["rows"] < PIPE_ROW_SHARE, "the limits pass a planted RoIAlign fault"


class CountedRoIAlign:
    """Within the block, count the multilevel RoIAlign calls with RoIs
    (``.with_rois``) and the K1 launches (``.launches``, from zero); with
    ``capture``, keep the inputs of the first call with RoIs of each pyramid
    shape and stage (``.shapes``, for ``hold_captured``)."""

    def __init__(self, capture=False):
        self.capture, self.shapes = capture, {}

    def __enter__(self):
        import deepemia_tpu_torch.models.heads as heads_mod
        from deepemia_tpu_torch.kernels.roi_align import counter

        self.heads, self.counter, self.real = heads_mod, counter, heads_mod.roi_align_dispatch
        self.with_rois, self.launches = 0, 0

        def dispatch(features, boxes, **kw):
            self.with_rois += int(boxes.shape[0] > 0)
            key = (tuple(features["p2"].shape), kw["output_size"])
            if self.capture and boxes.shape[0] and key not in self.shapes:
                self.shapes[key] = ([features[k] for k in ("p2", "p3", "p4", "p5")], boxes.clone(),
                                    {k: v.clone() if torch.is_tensor(v) else v for k, v in kw.items()})
            return self.real(features, boxes, **kw)

        heads_mod.roi_align_dispatch = dispatch
        counter.launches = 0
        return self

    def __exit__(self, *exc):
        self.launches = self.counter.launches
        self.heads.roi_align_dispatch = self.real


def cli_child(out_json: str, *argv: str) -> int:
    """Run ``python -m deepemia_tpu_torch.cli.main *argv`` in this process
    (``run_cli`` on the home ``$DEEPEMIA_TPU_HOME``) and write to
    ``out_json`` its exit code, the pipeline's result and device layout
    (its tile devices, whether the members ran at once, each engine's
    devices), its steady stage seconds, the RoIAlign counts and the
    RoIAlign backward (K2), int8 conv (K4) and activation quantizer (K5)
    launches. With ``$SMOKE_LOCAL_DEVICES`` (e.g. ``cuda:0,cuda:0``) the
    port sees those as the host's GPUs: two on one card. ``argv`` may hold
    several invocations apart by "::", run in turn: then ``out_json``
    holds the list of their reports."""
    runs = [[]]
    for a in argv:
        if a == "::":
            runs.append([])
        else:
            runs[-1].append(a)
    reports = []
    for k, run_argv in enumerate(runs):
        reports.append(_cli_report(run_argv))
        res = reports[-1]["result"]
        if len(runs) > 1 and res and os.path.isdir(res["output_dir"]):  # kept apart from the next run's
            old, new = res["output_dir"], f"{res['output_dir']}.run{k}"
            os.rename(old, new)
            reports[-1]["result"] = {key: v.replace(old, new, 1) if isinstance(v, str) and v.startswith(old) else v
                                     for key, v in res.items()}
    with open(out_json, "w") as f:
        json.dump(reports[0] if len(reports) == 1 else reports, f)
    return 0


def _cli_report(argv) -> dict:
    """One CLI invocation of ``cli_child`` -> its report."""
    import deepemia_tpu_torch.inference.pipeline as pipeline_mod

    if os.environ.get("SMOKE_LOCAL_DEVICES"):
        from deepemia_tpu_torch.parallel import mesh

        names = os.environ["SMOKE_LOCAL_DEVICES"].split(",")
        mesh.local_devices = lambda: [torch.device(n) for n in names]
    results, layouts = [], []
    real_run = pipeline_mod.InferencePipeline.run

    def run(self, *a, **kw):
        # a process group's tile devices are (rank, device) pairs
        layouts.append({"tile_devices": [str(d[1] if isinstance(d, tuple) else d) for d in self.tile_devices],
                        "member_parallel": self.member_parallel,
                        "engines": [[str(d) for d in e.devices] for _, e, _ in self.engines]})
        results.append(real_run(self, *a, **kw))
        return results[-1]

    pipeline_mod.InferencePipeline.run = run
    from deepemia_tpu_torch.kernels import int8_conv, int8_quant
    from deepemia_tpu_torch.kernels.roi_align import bwd_counter

    int8_conv.counter.launches = int8_quant.counter.launches = bwd_counter.launches = 0
    try:
        with StageLog() as stage_log, CountedRoIAlign() as roi:
            rc = run_cli(os.environ["DEEPEMIA_TPU_HOME"], *argv)
    finally:
        pipeline_mod.InferencePipeline.run = real_run
    return {"rc": rc, "result": results[0] if results else None, "layout": layouts[0] if layouts else None,
            "steady": stage_log.steady(), "with_rois": roi.with_rois, "launches": roi.launches,
            "k2_launches": bwd_counter.launches, "k4_launches": int8_conv.counter.launches,
            "k5_launches": int8_quant.counter.launches}


# the files ``cli_home`` writes (or futures of them), by (image index, JPEG or not, the micrograph's SHA-1): phases
# 12, 14 and 17 (a) write the same micrographs, and the LZW TIFF writer takes seconds at 2048²
_CLI_FILES = {}


def cli_file(i: int, img: np.ndarray, as_jpeg: bool) -> bytes:
    """The file ``cli_home`` writes for micrograph ``i``: its scale bar
    drawn, then gray JPEG (``jpeg_encode``) or the TIFF of CLI_ENCODINGS[i]
    (64-row strips)."""
    import tempfile

    gray = draw_scale_bar(img[..., 0], BARS[i][0], BARS[i][2])
    if as_jpeg:
        return jpeg_encode(gray, JPEG_QUALITY, (1, 1))
    _, comp, pred = CLI_ENCODINGS[i]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "f.tif")
        write_tiff(path, gray, comp, pred, rows_per_strip=64)
        with open(path, "rb") as f:
            return f.read()


def _cli_key(i: int, img: np.ndarray, as_jpeg: bool):
    import hashlib

    return i, as_jpeg, hashlib.sha1(np.ascontiguousarray(img).tobytes()).hexdigest()


def prefetch_cli_files(pool, images, jpeg=()):
    """``cli_file`` of each of ``images`` (JPEG where its index is in
    ``jpeg``) started in ``pool``, for ``cli_home`` to take."""
    for i, img in enumerate(images):
        _CLI_FILES.setdefault(_cli_key(i, img, i in jpeg), pool.submit(cli_file, i, img, i in jpeg))


def micrograph_index(name: str) -> int:
    """The index of ``micrograph_<i>.<ext>`` (BARS, CLI_ENCODINGS)."""
    return int(name.split("_", 1)[1].split(".", 1)[0])


def cli_home(model, images, config_hook=None, name="cli", jpeg=()):
    """A framework home under PIPELINE_DIR/<name> for the CLI: config.yaml
    (the defaults, through ``config_hook`` when given) and the dataset YAML
    of phase 9, dataset_info.json, the model as ``model_final_r50.pt``, and
    DATASET/INFERENCE with ``images`` (their scale bars drawn) as TIFFs in
    the CLI_ENCODINGS, strips of 64 rows, but those whose index is in
    ``jpeg`` as gray JPEG (``jpeg_encode``). -> (home, image folder)."""
    import yaml

    from deepemia_tpu_torch.config.config import default_config

    home = os.path.join(PIPELINE_DIR, name)
    cfg, split_dir, _, _ = pipeline_home(name, model, [])
    if config_hook:
        config_hook(cfg)
    os.makedirs(os.path.join(home, "config", "datasets"))
    with open(os.path.join(home, "config", "config.yaml"), "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    with open(os.path.join(home, "config", "datasets", "smoke.yaml"), "w") as f:
        yaml.safe_dump({"scale_bar_roi": SMOKE_ROI, "inference_overrides": SMOKE_OVERRIDE}, f)
    folder = os.path.join(home, "DATASET", "INFERENCE")
    os.makedirs(folder)
    with open(cfg["paths"]["category_json"], "w") as f:
        json.dump({"smoke": [folder, folder, ["particle", "pore"]]}, f)
    assert default_config(home)["paths"]["local_dataset_root"] == home
    for i, img in enumerate(images):
        key = _cli_key(i, img, i in jpeg)
        data = _CLI_FILES.get(key)
        if data is None:
            data = cli_file(i, img, i in jpeg)
        elif not isinstance(data, bytes):  # prefetched
            data = data.result()
        _CLI_FILES[key] = data
        with open(os.path.join(folder, f"micrograph_{i}.jpg" if i in jpeg else f"micrograph_{i}.tif"), "wb") as f:
            f.write(data)
    return home, folder


def cli_subprocess(home, argv, env=None):
    """``cli_child`` in a new process on the home ``home`` (``env`` added to
    its environment) -> (its JSON report, or the list of them where
    ``argv`` holds several invocations apart by "::", wall seconds, the
    completed process); raises if it failed."""
    out_json = os.path.join(home, "child.json")
    env = {**os.environ, "DEEPEMIA_TPU_HOME": home, **(env or {})}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", f"import sys, chip_smoke; sys.exit(chip_smoke.cli_child({out_json!r}, *{argv!r}))"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    wall = time.perf_counter() - t0
    if proc.returncode != 0 or not os.path.exists(out_json):
        print(proc.stdout[-4000:], proc.stderr[-8000:], sep="\n", file=sys.stderr, flush=True)
        raise AssertionError(f"the CLI's process exited {proc.returncode}")
    with open(out_json) as f:
        child = json.load(f)
    os.remove(out_json)
    assert all(c["rc"] == 0 for c in (child if isinstance(child, list) else [child])), proc.stderr[-4000:]
    return child, wall, proc


def phase_cli(model, images, device="cuda", config_hook=None):
    """Phase 12: the port's CLI in a subprocess, ``--task inference
    --visualize --id --draw-scalebar --no-download --no-upload``, on the
    three micrographs of phase 9 written as LZW, Deflate (predictor 2) and
    PackBits TIFF; every image processed, every bar read, one overlay per
    image and the legend, every multilevel RoIAlign with RoIs launching K1.
    -> (the K1 launches of the run, its RLE and measurement rows without
    their headers)."""
    from deepemia_tpu_torch.ops.image import read_image

    home, folder = cli_home(model, images, config_hook)
    names = sorted(os.listdir(folder))
    for (enc, _, _), name in zip(CLI_ENCODINGS, names):
        path = os.path.join(folder, name)
        secs = []
        for _ in range(3):
            t0 = time.perf_counter()
            img = read_image(path)
            secs.append(time.perf_counter() - t0)
        np.testing.assert_array_equal(img[..., 0], draw_scale_bar(images[names.index(name)][..., 0],
                                                                  BARS[names.index(name)][0], BARS[names.index(name)][2]))
        print(f"cli: decode {enc} TIFF {img.shape[0]}x{img.shape[1]} ({os.path.getsize(path)} bytes, 64-row strips): "
              f"{float(np.median(secs)):.4f} s (median of 3, host)", flush=True)
    argv = ["--task", "inference", "--dataset_name", "smoke", "--visualize", "--id", "--draw-scalebar",
            "--no-download", "--no-upload", "--device", device]
    child, wall, proc = cli_subprocess(home, argv)
    res = child["result"]
    assert res["processed"] == names and not res["failed"], res
    meas = read_csv(res["measurements_csv"])
    rle = read_csv(res["rle_csv"])[1:]
    check_scale_bars(res, meas, names)
    out = res["output_dir"]
    for name in names:
        ov = read_image(os.path.join(out, f"{name}_predictions.png"))
        assert ov.shape == images[0].shape, (name, ov.shape)
        assert any(r[0] == name for r in rle), name
    legend = read_image(os.path.join(out, "class_legend.png"))
    assert legend.shape == (60, 260, 3), legend.shape
    print(f"cli: {len(names)} images processed ({', '.join(e for e, _, _ in CLI_ENCODINGS)} TIFF), rle_rows={len(rle)} "
          f"measurement_rows={len(meas) - 1}, {len(names)} overlays {ov.shape[0]}x{ov.shape[1]} and class_legend.png "
          f"read back; the CLI process took {wall:.1f} s", flush=True)
    print(f"cli: multilevel_roi_align calls with RoIs {child['with_rois']}, roi_align_fwd launches={child['launches']}",
          flush=True)
    preflight = [ln for ln in proc.stderr.splitlines() if "CUDA device:" in ln or "on the CPU, as asked" in ln]
    assert preflight, "the CLI logged no device preflight"
    print(f"cli: preflight {preflight[0].split(': ', 1)[-1]}", flush=True)
    try:
        import psutil  # noqa: F401

        has_psutil = True
    except ImportError:
        has_psutil = False
    from deepemia_tpu_torch.utils.logging_utils import log_memory_usage

    print(f"cli: psutil importable={has_psutil}; this process's memory (MB) {json.dumps(log_memory_usage('smoke'))}",
          flush=True)
    if device == "cuda":
        assert child["launches"] > 0 and child["launches"] == child["with_rois"], \
            "a multilevel RoIAlign of the CLI's run did not launch K1"
    secs = res["seconds_per_image"]
    print(f"cli: seconds_per_image first={secs[0]:.4f} steady={[round(x, 4) for x in secs[1:]]} "
          f"({images[0].shape[0]}x{images[0].shape[1]}, bf16, visualize, default config)", flush=True)
    print("cli stage seconds: " + json.dumps(
        {k: {"total_s": round(v["total_s"], 6), "count": v["count"]} for k, v in res["stages"].items()}), flush=True)
    print(f"cli: steady stage seconds per image {json.dumps(child['steady'])}", flush=True)
    return child["launches"], (rle, meas[1:])


def phase_device_measurements(model, images, device="cuda", config_hook=None):
    """Phase 12, in process: ``measurement_backend: device`` on phase 12's
    last image (every RoIAlign with RoIs launching K1); the device measurements
    of its instances on the card against the CPU (counts,
    extents, perimeters and contrast equal, moments to 1e-5 relative); and
    one 256² image through the pipeline with the device backend on the card
    and on the CPU, compared as phase 9's reference is. -> K1 launches."""
    from deepemia_tpu_torch.config.schema import validate_config
    from deepemia_tpu_torch.inference import measure as measure_lib
    from deepemia_tpu_torch.inference.detections import InstanceSet
    from deepemia_tpu_torch.inference.pipeline import InferencePipeline
    from deepemia_tpu_torch.ops.image import read_image

    import shutil

    source = os.path.join(PIPELINE_DIR, "cli", "DATASET", "INFERENCE")
    folder = os.path.join(PIPELINE_DIR, "device_images")
    os.makedirs(folder, exist_ok=True)
    last_name = sorted(os.listdir(source))[-1]
    shutil.copyfile(os.path.join(source, last_name), os.path.join(folder, last_name))
    cfg, split_dir, _, out = pipeline_home("device", model, [])
    if config_hook:
        config_hook(cfg)
    cfg["performance"]["measurement_backend"] = "device"
    cfg["measure_contrast_distribution"] = True
    pipe = InferencePipeline("smoke", split_dir, out, validate_config(cfg), device=device)
    last = {}
    real_infer = pipe._infer_one

    def infer(image, timers):
        last["inst"], q = real_infer(image, timers)
        return last["inst"], q

    pipe._infer_one = infer
    with StageLog() as stage_log, CountedRoIAlign() as roi:
        res = pipe.run(folder, visualize=False)
    names = sorted(os.listdir(folder))
    assert res["processed"] == names and not res["failed"], res
    m = res["stages"]["measurements"]
    print(f"device measurements: {len(names)} images, measurements stage {m['total_s'] / m['count']:.4f} s per image "
          f"(steady stages {json.dumps(stage_log.steady())}); multilevel_roi_align calls with RoIs {roi.with_rois}, "
          f"roi_align_fwd launches={roi.launches}", flush=True)
    if device == "cuda":
        assert roi.launches > 0 and roi.launches == roi.with_rois, "a RoIAlign with RoIs did not launch K1"
    inst = last["inst"]
    img = torch.from_numpy(read_image(os.path.join(folder, names[-1])))
    _, secs = sync_time(lambda: measure_lib.measure_instances_device(inst, img.to(device), measure_contrast=True))
    got = measure_lib.measure_instances_device(inst, img.to(device), measure_contrast=True)
    cpu_inst = InstanceSet(*(t.cpu() for t in inst)) if device == "cuda" else inst
    ref = measure_lib.measure_instances_device(cpu_inst, img, measure_contrast=True)
    exact = ("area", "pixel_count", "perimeter", "rect_w", "rect_h", "contrast_d10", "contrast_d50", "contrast_d90",
             "valid")
    worst = 0.0
    for k, v in ref.items():
        g = got[k].cpu()
        if k in exact:
            assert torch.equal(g, v), (k, int((g != v).sum()))
        else:
            rel = float(((g - v).abs() / v.abs().clamp(min=1e-6)).max()) if v.numel() else 0.0
            worst = max(worst, rel)
            assert rel <= 1e-5, (k, rel)
    n = int(inst.valid.sum())
    print(f"device measurements card vs CPU on {n} instances of {names[-1]}: counts, extents, perimeters and "
          f"contrast equal; moments max relative difference {worst:.3g} (limit 1e-5); "
          f"measure_instances_device {secs:.4f} s on the card", flush=True)
    if device == "cuda":
        img256 = synthetic_micrograph(256, seed=7)
        rle_c, meas_c = pipeline_csvs(model, img256, "dev_cpu", "cpu", backend="device")
        rle_g, meas_g = pipeline_csvs(model, img256, "dev_cuda", "cuda", backend="device")
        a = csv_agreement(rle_g, meas_g, rle_c, meas_c)
        print("device measurements 256² f32 card vs CPU: " + json.dumps(a), flush=True)
        assert min(a["n_card"], a["n_cpu"], a["rows_card"], a["rows_cpu"]) > 0
        assert a["inst"] >= PIPE_MATCH_SHARE and a["rows"] >= PIPE_ROW_SHARE, a
    return roi.launches


def phase_windowed_rle(model, size=4096, device="cuda", config_hook=None):
    """Phase 12: one size² micrograph through the pipeline without
    overlays, so the RLE takes the windowed device encoder (above 2048²);
    its rows must equal the full-image encoder's on the same instances.
    -> K1 launches."""
    from deepemia_tpu_torch.config.schema import validate_config
    from deepemia_tpu_torch.inference.pipeline import PASTE_BUDGET, InferencePipeline
    from deepemia_tpu_torch.ops.masks import paste_masks
    from deepemia_tpu_torch.ops.rle import rle_encode_batch

    img = synthetic_micrograph(size, seed=11)
    cfg, split_dir, folder, out = pipeline_home("windowed", model, [img])
    if config_hook:
        config_hook(cfg)
    pipe = InferencePipeline("smoke", split_dir, out, validate_config(cfg), device=device)
    kept = {}
    real_infer = pipe._infer_one

    def infer(image, timers):
        kept["inst"], q = real_infer(image, timers)
        return kept["inst"], q

    pipe._infer_one = infer
    with StageLog() as stage_log, CountedRoIAlign() as roi:
        res = pipe.run(folder, visualize=False)
    assert not res["failed"], res
    if device == "cuda":
        assert roi.launches > 0 and roi.launches == roi.with_rois, "a RoIAlign with RoIs did not launch K1"
    inst, hw, name = kept["inst"], (size, size), res["processed"][0]
    assert hw[0] * hw[1] > 2048 * 2048, "the windowed encoder runs above 2048² only"
    rows = read_csv(res["rle_csv"])[1:]
    with torch.inference_mode():
        max_runs = min(hw[0] * hw[1] // 2 + 1, 4 * max(hw))
        chunk = max(1, PASTE_BUDGET // (hw[0] * hw[1]))
        parts = []
        for s0 in range(0, inst.capacity, chunk):
            m = paste_masks(inst.mask_probs[s0 : s0 + chunk], inst.boxes[s0 : s0 + chunk], hw[0], hw[1],
                            pipe.mask_threshold) & inst.valid[s0 : s0 + chunk, None, None]
            parts.append(rle_encode_batch(m, max_runs=max_runs))
        starts, lengths, n_runs = (torch.cat(t) for t in zip(*parts))
        packed = torch.cat([starts, lengths, n_runs[:, None]], dim=1).cpu().numpy()
        valid = inst.valid.cpu().numpy()
        full = pipe._rle_rows(name, inst, [i for i in range(len(valid)) if valid[i]], hw, packed, max_runs)
    assert len(rows) == len(full) > 0 and [list(r) for r in full] == rows, \
        "the windowed RLE differs from the full-image encoder's"
    secs = res["seconds_per_image"]
    print(f"windowed rle: {size}x{size}, {len(rows)} instances, rows equal to the full-image encoder's; "
          f"seconds {secs[0]:.4f} (one image, bf16, default config, no overlays); multilevel_roi_align calls with "
          f"RoIs {roi.with_rois}, roi_align_fwd launches={roi.launches}", flush=True)
    print(f"windowed rle: stage seconds {json.dumps({k: round(v['total_s'], 4) for k, v in res['stages'].items()})}",
          flush=True)
    return roi.launches


DATASET_DIR = os.path.join(ROOT, "build", "chip_smoke_dataset")
# phase 13's dataset: ten 1024x768 grey micrographs (a common SEM frame),
# 10-40 labelled instances each (polygons and ellipses, two classes, some
# wider than 96 px so every COCO area range has ground truth)
DATASET_IMAGES = 10
DATASET_HW = (768, 1024)
TRAIN_STEPS = 12
TUNE_STEPS = 4
HPO_TRIALS, HPO_STEPS = 2, 4


def draw_labelled(rng, hw=DATASET_HW):
    """One labelled micrograph from ``rng``: a noisy gray background and
    10-40 instances (polygons and ellipses, classes ``particle`` and
    ``pore``, some wider than 96 px) drawn bright with the port's
    ``fill_poly`` as the dataset rasterises them -> (gray [H,W] uint8, the
    label JSON's ``instances``)."""
    from deepemia_tpu_torch.data.datasets import ellipse_to_polygon
    from deepemia_tpu_torch.ops.cv import fill_poly

    h, w = hw
    gray = np.clip(rng.normal(80.0, 12.0, (h, w)), 0, 255).astype(np.uint8)
    instances = []
    for j in range(int(rng.integers(10, 41))):
        cls = ("particle", "pore")[j % 2]
        cx, cy = rng.uniform(40, w - 40), rng.uniform(40, h - 40)
        big = rng.random() < 0.15
        r = rng.uniform(50, 90) if big else rng.uniform(6, 30)
        if rng.random() < 0.5:
            inst = dict(type="ellipse", className=cls, cx=cx, cy=cy, rx=r, ry=r * rng.uniform(0.5, 1.0),
                        angle=rng.uniform(0, 180))
            poly = ellipse_to_polygon(inst["cx"], inst["cy"], inst["rx"], inst["ry"], inst["angle"])
        else:
            k = int(rng.integers(5, 10))
            ang = np.sort(rng.uniform(0, 2 * np.pi, k))
            rad = r * rng.uniform(0.6, 1.0, k)
            pts = np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], 1)
            inst = dict(type="polygon", className=cls, points=pts.ravel().tolist())
            poly = (pts + 0.5).ravel().tolist()
        mask = np.zeros((h, w), np.uint8)
        fill_poly(mask, np.round(np.asarray(poly).reshape(-1, 2)).astype(np.int32), 1)
        gray[mask.astype(bool)] = np.uint8(rng.uniform(160, 230))
        instances.append(inst)
    return gray, instances


def synthetic_dataset(root: str, n: int, hw=DATASET_HW, seed: int = 13) -> str:
    """``n`` labelled micrographs under ``root``: LZW TIFFs (64-row strips),
    every other one (even indices) a gray JPEG (``jpeg_encode``, quality
    95) instead, with per-image label JSONs in the reference format (``metadata.name/
    height/width``; ``instances`` of type ``polygon`` (star-shaped, 5-9
    points) and ``ellipse``, drawn by ``draw_labelled``). -> root."""
    rng = np.random.default_rng(seed)
    h, w = hw
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        gray, instances = draw_labelled(rng, hw)
        name = f"sem_{i:02d}.{'jpg' if i % 2 == 0 else 'tif'}"
        if i % 2 == 0:
            write_jpeg(os.path.join(root, name), gray)
        else:
            write_tiff(os.path.join(root, name), gray, 5, rows_per_strip=64)
        with open(os.path.join(root, f"sem_{i:02d}.json"), "w") as f:
            json.dump({"metadata": {"name": name, "height": h, "width": w}, "instances": instances}, f)
    return root


def zoo_pickle(path: str, seed: int = 0) -> dict:
    """A Detectron2-named zoo pickle (``{"model": {name: ndarray}}``) of the
    seeded R50 training model with COCO's 81-class box and mask heads ->
    its state dict."""
    import pickle

    from deepemia_tpu_torch.models.mask_rcnn import build_train_model

    sd = {k: v.float().numpy() for k, v in build_train_model("R50", 2, device="cpu", seed=seed).state_dict().items()}
    rng = np.random.default_rng(seed)
    for name, shape in (("roi_heads.box_predictor.cls_score", (81, 1024)), ("roi_heads.box_predictor.bbox_pred", (320, 1024)),
                        ("roi_heads.mask_head.predictor", (80, 256, 1, 1))):
        sd[f"{name}.weight"] = rng.normal(0, 0.01, shape).astype(np.float32)
        sd[f"{name}.bias"] = np.zeros(shape[0], np.float32)
    with open(path, "wb") as f:
        pickle.dump({"model": sd, "__author__": "Detectron2 Model Zoo"}, f, protocol=2)
    return sd


class TrainRun:
    """Within the block, each ``train_step`` is timed (synchronised on
    ``device``) with its K1/K2 launches, each batch the trainer takes from
    the ``TrainLoader`` is timed from request to hand-over (the step's wait
    on the loader), and every ``load_pretrained_params`` result is kept."""

    def __init__(self, device="cuda"):
        self.device = device

    def __enter__(self):
        from deepemia_tpu_torch.data import loader as loader_mod
        from deepemia_tpu_torch.kernels.roi_align import bwd_counter, counter
        from deepemia_tpu_torch.train import trainer as trainer_mod

        self.steps, self.waits, self.requests, self.pretrained = [], [], [], []
        self.mods = (loader_mod, trainer_mod)
        self.real = (loader_mod.TrainLoader.__iter__, trainer_mod.train_step, trainer_mod.load_pretrained_params)
        real_iter, real_step, real_pretrained = self.real
        sync = torch.cuda.synchronize if self.device == "cuda" else (lambda: None)

        def timed_iter(loader):
            stream = real_iter(loader)
            while True:
                t0 = time.perf_counter()
                batch = next(stream)
                self.requests.append(t0)
                self.waits.append(time.perf_counter() - t0)
                yield batch

        def timed_step(*args, **kw):
            k1, k2 = counter.launches, bwd_counter.launches
            sync()
            t0 = time.perf_counter()
            metrics = real_step(*args, **kw)
            sync()
            self.steps.append(dict(metrics, seconds=time.perf_counter() - t0, k1=counter.launches - k1,
                                   k2=bwd_counter.launches - k2))
            return metrics

        def pretrained(*args, **kw):
            self.pretrained.append(real_pretrained(*args, **kw))
            return self.pretrained[-1]

        loader_mod.TrainLoader.__iter__ = timed_iter
        trainer_mod.train_step = timed_step
        trainer_mod.load_pretrained_params = pretrained
        return self

    def __exit__(self, *exc):
        loader_mod, trainer_mod = self.mods
        loader_mod.TrainLoader.__iter__, trainer_mod.train_step, trainer_mod.load_pretrained_params = self.real


def loader_batch(cfg, files, batch_size, dataset="sem"):
    """The first batch of ``batch_size`` images that the training loader
    (one worker, augmentation on, the config's size) makes from ``files``
    of ``dataset``."""
    from deepemia_tpu_torch.data.datasets import get_split_dicts, read_dataset_info
    from deepemia_tpu_torch.data.loader import TrainLoader

    img_dir, label_dir, _ = read_dataset_info(cfg["paths"]["category_json"])[dataset]
    records = get_split_dicts(img_dir, label_dir, files, cfg["paths"]["category_json"], dataset)
    tc = cfg.get("train", {})
    loader = TrainLoader(records, batch_size, tc.get("train_size", 512), tc.get("max_instances", 64), augment=True,
                         workers=1)
    try:
        return next(iter(loader))
    finally:
        loader.close()


def hold_train_capture(calls, label):
    """K2 (bf16 and float32) and K1 against their plain versions on the
    RoIAlign inputs and cotangents of one captured training step, and the
    adjoint identity, untimed -> (K1 errors, K2 errors)."""
    from deepemia_tpu_torch.models.roi_align import assign_fpn_levels

    k1_errs, k2_errs = [], []
    for call, tag in zip(calls, ("box", "mask")):
        boxes, bidx = call["boxes"], call["bidx"]
        levels = (assign_fpn_levels(boxes) - 2).contiguous()
        shapes = [tuple(f.shape[:3]) for f in call["feats"]]
        for dtype in (torch.bfloat16, torch.float32):
            *_, err, line = compare_backward(f"{label}, {tag} stage {shapes[0]} p2", call["g"].to(dtype), boxes,
                                             levels, bidx, shapes, dtype)
            print(line, flush=True)
            k2_errs.append(err)
        check_adjoint(f"{label}, {tag} stage", [f.float().contiguous() for f in call["feats"]], boxes, levels, bidx,
                      call["g"].float())
        valid = torch.ones(boxes.shape[0], dtype=torch.bool, device="cuda")
        k1_errs.append(compare_roi_align(f"{label}, {tag} stage (K1)", call["feats"], boxes, valid, bidx, call["out"],
                                         call["feats"][0].dtype, timed=False)["err"])
    return k1_errs, k2_errs


def step_stats(run, steps) -> str:
    """Steady step statistics of a ``TrainRun`` of ``steps`` steps (steps 3
    to the last): ``train_step`` seconds (synchronised), the wall seconds
    from one batch request to the next, the wait in ``next(loader)`` and its
    share of the wall time."""
    step_s = float(np.median([st["seconds"] for st in run.steps[2:steps]]))
    waits = run.waits[2:steps]
    span = run.requests[steps - 1] - run.requests[2]
    share = sum(run.waits[2 : steps - 1]) / span
    return (f"steady seconds/step={step_s:.6f} (median of steps 3-{steps}, train_step synchronised) "
            f"wall seconds/step={span / (steps - 3):.6f} (batch request to batch request) "
            f"loader wait/step median={float(np.median(waits)):.6f} mean={float(np.mean(waits)):.6f} "
            f"(in next(loader)) loader share={share:.4f} of the wall time; first step "
            f"{run.steps[0]['seconds']:.4f} s after a {run.waits[0]:.4f} s wait")


class TimedInfer:
    """Within the block, each ``TileEngine.infer`` call is timed
    (synchronised on ``device``) and its valid detections counted."""

    def __init__(self, device="cuda"):
        self.device = device

    def __enter__(self):
        from deepemia_tpu_torch.inference.engine import TileEngine

        self.cls, self.real, self.seconds, self.detections = TileEngine, TileEngine.infer, [], []
        sync = torch.cuda.synchronize if self.device == "cuda" else (lambda: None)

        def infer(engine, *args, **kw):
            sync()
            t0 = time.perf_counter()
            out = self.real(engine, *args, **kw)
            sync()
            self.seconds.append(time.perf_counter() - t0)
            self.detections.append(int(out[0].valid.sum()))
            return out

        TileEngine.infer = infer
        return self

    def __exit__(self, *exc):
        self.cls.infer = self.real


def run_cli(home: str, *argv: str) -> int:
    """``python -m deepemia_tpu_torch.cli.main *argv`` in this process
    (``runpy``, as ``-m`` runs it) on the framework home ``home`` -> its
    exit code."""
    import runpy

    import deepemia_tpu_torch.config.config as port_cfg

    before = os.environ.get("DEEPEMIA_TPU_HOME")
    os.environ["DEEPEMIA_TPU_HOME"] = home
    port_cfg._default_store = None
    sys.argv = ["deepemia_tpu_torch.cli.main", *argv]
    try:
        runpy.run_module("deepemia_tpu_torch.cli.main", run_name="__main__", alter_sys=True)
    except SystemExit as e:
        return e.code
    finally:
        if before is None:
            del os.environ["DEEPEMIA_TPU_HOME"]
        else:
            os.environ["DEEPEMIA_TPU_HOME"] = before
        port_cfg._default_store = None
    return 0


def phase_train_dataset(device="cuda", config_hook=None, n_images=DATASET_IMAGES, hw=DATASET_HW,
                        steps=TRAIN_STEPS):
    """Phase 13: training from a dataset through the port's CLI, in
    process, on ``n_images`` synthetic labelled micrographs (Mask R-CNN
    R50-FPN, 2 classes, the default config: 2 x 512² a step, 64 GT slots,
    bf16 over float32 master weights, two loader workers): ``--task
    prepare`` (an 80/20 split); K1 and K2 against their plain versions on
    one training step of a 4-image loader batch (the batch an HPO winner
    with ``ims_per_batch`` 4 trains on); ``train --rcnn 50 --augment
    --max-iter <steps>`` (finite losses, 2 K1 + 2 K2 launches a step,
    checkpoints and ``model_final_r50.pt``, weights moved); ``evaluate
    --rcnn 50 --visualize`` (the JAX evaluator's metric names, finite, one
    overlay and 2 K1 launches per test image, K1 against its plain version
    at the whole-image pass's non-square levels); ``train --pretrained-weights
    <zoo.pkl>`` for TUNE_STEPS steps (81-class heads skipped and
    re-initialised, stem and res2 as loaded), and ``train --optimize
    --n-trials 2 --max-iter 4 --hpo-strategy random`` (the winner in
    config.yaml and the dataset YAML, no trial directory left).
    -> (K1 launches, K2 launches, K1 errors, K2 errors) of the phase."""
    import shutil

    import yaml

    from deepemia_tpu_torch.config.config import default_config
    from deepemia_tpu_torch.models.mask_rcnn import build_train_model
    from deepemia_tpu_torch.train.trainer import zero_residual_norms

    shutil.rmtree(DATASET_DIR, ignore_errors=True)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    home = os.path.join(DATASET_DIR, "home")
    t0 = time.perf_counter()
    root = synthetic_dataset(os.path.join(home, "DATASET", "sem"), n_images, hw)
    print(f"dataset: {n_images} micrographs {hw[1]}x{hw[0]} (LZW TIFF and, every other one, JPEG) with labels "
          f"written in {time.perf_counter() - t0:.1f} s", flush=True)
    cfg = default_config(home)
    if config_hook:
        config_hook(cfg)
    os.makedirs(os.path.join(home, "config"))
    with open(os.path.join(home, "config", "config.yaml"), "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    with open(cfg["paths"]["category_json"], "w") as f:
        json.dump({"sem": [root, root, ["particle", "pore"]]}, f)
    flags = ["--dataset_name", "sem", "--no-download", "--no-upload", "--device", device, "--verbosity", "warning"]
    split_dir = cfg["paths"]["split_dir"]
    out_r50 = os.path.join(split_dir, "sem", "rcnn_r50")
    k1 = k2 = 0

    assert run_cli(home, "--task", "prepare", *flags) == 0
    with open(os.path.join(split_dir, "sem_split.json")) as f:
        split = json.load(f)
    n_test = math.ceil(0.2 * n_images)
    assert len(split["train"]) == n_images - n_test and len(split["test"]) == n_test, split
    jpeg_records = {k: sum(int(f[4:6]) % 2 == 0 for f in v) for k, v in split.items()}
    # at the default ten images the split (seed 42) puts JPEGs in both parts
    assert jpeg_records["train"] and (jpeg_records["test"] or n_images != DATASET_IMAGES), jpeg_records
    print(f"prepare: split {len(split['train'])}/{len(split['test'])}, JPEG records {json.dumps(jpeg_records)}",
          flush=True)
    k1_errs, k2_errs = [], []
    if device == "cuda":
        k1_errs, k2_errs = hold_train_capture(capture_train_step(loader_batch(cfg, split["train"], 4)),
                                              "4-image loader batch")

    # train from scratch
    with TrainRun(device) as run, CountedRoIAlign() as roi:
        t0 = time.perf_counter()
        rc = run_cli(home, "--task", "train", "--rcnn", "50", "--augment", "--max-iter", str(steps), *flags)
        wall = time.perf_counter() - t0
    assert rc == 0, rc
    train_steps, waits = run.steps[:steps], run.waits[:steps]
    assert len(run.steps) == steps and len(waits) == steps, (len(run.steps), len(waits))
    for st in train_steps:
        assert all(math.isfinite(st[k]) for k in ("rpn_cls", "rpn_loc", "cls", "box", "mask", "total")), st
        if device == "cuda":
            assert st["k1"] == 2 and st["k2"] == 2, st
    assert os.listdir(os.path.join(out_r50, "ckpts")) and os.path.exists(os.path.join(out_r50, "model_final_r50.pt"))
    start = build_train_model("R50", 2, device="cpu", seed=0)
    zero_residual_norms(start)
    after = torch.load(os.path.join(out_r50, "model_final_r50.pt"), map_location="cpu")["model"]
    moved = sum(not torch.equal(v, after[k]) for k, v in start.state_dict().items())
    assert moved > 0
    tc = cfg.get("train", {})
    setting = (f"R50-FPN, 2 x {tc.get('train_size', 512)}², {tc.get('max_instances', 64)} GT slots, "
               f"{'bf16' if cfg['performance'].get('use_bf16', True) else 'float32'}, augment")
    print(f"train: {steps} steps from {len(split['train'])} records ({setting}, {tc.get('loader_workers', 2)} loader "
          f"workers): {step_stats(run, steps)}; the task took {wall:.1f} s; {moved} parameter tensors moved; "
          "losses at the last step "
          + json.dumps({k: round(train_steps[-1][k], 5) for k in ("rpn_cls", "rpn_loc", "cls", "box", "mask", "total")}),
          flush=True)
    print("train: loader waits " + json.dumps([round(x, 4) for x in waits]), flush=True)
    k1, k2 = k1 + roi.launches, k2 + sum(st["k2"] for st in run.steps)

    # evaluate
    with CountedRoIAlign(capture=True) as roi, TimedInfer(device) as infer:
        t0 = time.perf_counter()
        assert run_cli(home, "--task", "evaluate", "--rcnn", "50", "--visualize", *flags) == 0
        wall = time.perf_counter() - t0
    out = os.path.join(cfg["paths"]["output_dir"], "sem", "eval_r50")
    with open(os.path.join(out, "metrics.csv")) as f:
        rows = [ln.split(",") for ln in f.read().splitlines()[1:]]
    metrics = {k: float(v) for k, v in rows}
    want = {f"{t}/{m}" for t in ("bbox", "segm") for m in ("AP", "AP50", "AP75", "APs", "APm", "APl", "AR1", "AR10",
                                                          "AR100", "ARs", "ARm", "ARl", "AP-class0", "AP-class1")}
    assert set(metrics) == want | {"eval_seconds", "num_images"}, sorted(metrics)
    assert all(math.isfinite(v) for v in metrics.values()), metrics
    overlays = sorted(p for p in os.listdir(out) if p.endswith("_eval.png"))
    assert len(overlays) == n_test and metrics["num_images"] == n_test, (overlays, metrics["num_images"])
    if device == "cuda":
        assert roi.launches == roi.with_rois == 2 * n_test, (roi.launches, roi.with_rois)
        # the whole-image pass pads 1024x768 only to /64: non-square levels
        errs, _ = hold_captured(roi.shapes, "evaluate")
        k1_errs += errs
    print(f"evaluate: {n_test} test images, {metrics['eval_seconds'] / n_test:.4f} s per image (the evaluator's "
          f"clock; the task took {wall:.1f} s; TileEngine.infer per image {[round(x, 4) for x in infer.seconds]} "
          f"with {infer.detections} detections at the 0.45 threshold), roi_align_fwd launches={roi.launches} "
          "(2 per image), "
          f"{len(overlays)} overlays; bbox/AP={metrics['bbox/AP']:.4f} segm/AP={metrics['segm/AP']:.4f} "
          f"(random init, {steps} steps)", flush=True)
    k1 += roi.launches

    # fine-tune from a zoo pickle with 81-class heads
    zoo = os.path.join(DATASET_DIR, "zoo_r50.pkl")
    zoo_sd = zoo_pickle(zoo)
    shutil.rmtree(os.path.join(out_r50, "ckpts"))  # a fresh run, not a resume of the one above
    with TrainRun(device) as run, CountedRoIAlign() as roi:
        rc = run_cli(home, "--task", "train", "--rcnn", "50", "--pretrained-weights", zoo, "--max-iter",
                     str(TUNE_STEPS), *flags)
    assert rc == 0 and len(run.steps) == TUNE_STEPS and len(run.pretrained) == 1, (rc, len(run.steps))
    info = run.pretrained[0]
    skipped = sorted(name for name, _, _ in info["skipped"])
    assert skipped == [f"roi_heads.{n}.{p}" for n in ("box_predictor.bbox_pred", "box_predictor.cls_score",
                                                      "mask_head.predictor") for p in ("bias", "weight")], skipped
    after = torch.load(os.path.join(out_r50, "model_final_r50.pt"), map_location="cpu")["model"]
    frozen = [k for k in after if k.startswith(("backbone.bottom_up.stem.", "backbone.bottom_up.res2."))]
    assert frozen and all(np.array_equal(after[k].numpy(), zoo_sd[k]) for k in frozen)
    assert after["roi_heads.box_predictor.cls_score.weight"].shape == (3, 1024)
    print(f"fine-tune: {info['used']} tensors loaded from the zoo pickle, skipped and re-initialised "
          f"{len(skipped)} ({', '.join(skipped)}); {len(frozen)} stem/res2 tensors unchanged after "
          f"{TUNE_STEPS} steps", flush=True)
    k1, k2 = k1 + roi.launches, k2 + sum(st["k2"] for st in run.steps)

    # random-search HPO (its winner's run starts afresh: the fine-tuning
    # run's optimizer holds only the unfrozen tensors)
    shutil.rmtree(os.path.join(out_r50, "ckpts"))
    with TrainRun(device) as run, CountedRoIAlign() as roi:
        t0 = time.perf_counter()
        rc = run_cli(home, "--task", "train", "--rcnn", "50", "--optimize", "--n-trials", str(HPO_TRIALS),
                     "--max-iter", str(HPO_STEPS), "--hpo-strategy", "random", *flags)
        wall = time.perf_counter() - t0
    assert rc == 0, rc
    with open(os.path.join(home, "config", "config.yaml")) as f:
        best = yaml.safe_load(f)["rcnn_hyperparameters"]["best"]["R50"]
    with open(os.path.join(cfg["paths"]["dataset_configs_dir"], "sem.yaml")) as f:
        ds_best = yaml.safe_load(f)["rcnn_hyperparameters"]["best_R50"]
    assert best == ds_best and set(best) == {"base_lr", "ims_per_batch", "warmup_iters", "gamma",
                                             "batch_size_per_image"}, (best, ds_best)
    assert not [p for p in os.listdir(os.path.join(split_dir, "sem")) if p.startswith("hpo_")]
    print(f"hpo: {HPO_TRIALS} random trials of {HPO_STEPS} steps and the winner's run in {wall:.1f} s "
          f"({len(run.steps)} steps); "
          f"winner {json.dumps(best)} in config.yaml and sem.yaml; trial directories removed", flush=True)
    k1, k2 = k1 + roi.launches, k2 + sum(st["k2"] for st in run.steps)
    if device == "cuda":
        print(f"train from a dataset: peak_memory_allocated_GB={torch.cuda.max_memory_allocated() / 1e9:.4f}",
              flush=True)
    shutil.rmtree(DATASET_DIR, ignore_errors=True)
    return k1, k2, k1_errs, k2_errs


def check_window_sum(tag, f, got, expect_instance=None):
    """K3's [1,1] output ``got`` for ``f`` against the plain version within
    K3_TOL of sum |x| over the window; -> the absolute error. Prints the
    plan instance that ran."""
    from deepemia_tpu_torch.kernels import window_sum as ws

    torch.cuda.synchronize()
    plan = ws.plan_of(f.contiguous())
    ref = ws.window_sum_plain(f)
    scale = float(f[: ws.WINDOW[0], : ws.WINDOW[1]].float().abs().sum())
    err = float((got - ref).abs().max())
    tol = K3_TOL * scale
    line = (f"window_sum {tag} {tuple(f.shape)} {str(f.dtype).split('.')[-1]} "
            f"instance={ws.INSTANCE_NAMES[plan.instance]}: kernel={float(got):.6f} plain={float(ref):.6f} "
            f"max_abs_err={err:.3g} tol={tol:.3g} (sum |x| {scale:.6g})")
    print(line, flush=True)
    if not (scale > 0 and err <= tol and math.isfinite(err)):
        raise AssertionError(f"{line}: kernel disagrees with plain")
    if expect_instance is not None and plan.instance != expect_instance:
        raise AssertionError(f"{line}: expected instance {ws.INSTANCE_NAMES[expect_instance]}")
    return err


def window_sum_edge_cases(dtype, gen):
    """(name, operand, expected plan instance) for K3's edge cases: the
    map is exactly the window; C in {1, 3, 8, 257}; a row pitch W*C*esize
    that is not a multiple of 16; a contiguous view one element past a
    16-byte boundary; a transposed view (copied by the wrapper); values of
    ~1e4 beside ~1e-3."""
    from deepemia_tpu_torch.kernels.window_sum import SCALAR, VECTOR

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    mixed = torch.randn((20, 33, 64), generator=gen, device="cuda")
    mixed *= torch.where(torch.rand((20, 33, 64), generator=gen, device="cuda") < 0.5, 1e4, 1e-3)
    return [
        ("exact 8x16xC", randn(8, 16, 256), VECTOR),
        ("C=1", randn(20, 33, 1), SCALAR),
        ("C=3", randn(20, 33, 3), SCALAR),
        ("C=8", randn(20, 33, 8), VECTOR),
        ("C=257", randn(20, 33, 257), SCALAR),
        ("pitch % 16 != 0", randn(12, 21, 10), SCALAR),
        ("base + 1 element", randn(12 * 20 * 64 + 1)[1:].view(12, 20, 64), SCALAR),
        ("transposed view", randn(33, 20, 64).transpose(0, 1), VECTOR),
        ("mixed 1e4 / 1e-3", mixed.to(dtype), VECTOR),
    ]


def device_ms(fn, n=200, skip=frozenset()):
    """Device time per call of the kernels ``fn`` launches, from
    torch.profiler (CUDA activity) over ``n`` calls, each after the
    L2-evicting write of time_ms: for each device event kind but those in
    ``skip`` (the write's own), its mean self device time times its events
    per call (the profiler drops some records, up to 9 % seen, so counts
    are rounded; a window in which it kept no record of ``fn``'s kernels at
    all, seen once on K5, is profiled again, up to three times); -> (ms per
    call, {event kind: count})."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
                and not e.is_user_annotation and e.key not in skip]
        if rows:
            break
    return sum(t / c * max(1, round(c / n)) for _, t, c in rows) / 1e3, {k: c for k, _, c in rows}


def host_ms(fn, n=1000):
    """Median host time of one call of ``fn`` over ``n`` calls back to
    back (the wrapper and the launch; the device keeps up)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter_ns()
        fn()
        ts.append(time.perf_counter_ns() - t0)
    torch.cuda.synchronize()
    return float(np.median(ts)) / 1e6


def window_sum_times(timed):
    """Times each function of ``timed`` ({dtype: {name: fn}}) in turns,
    forward and back, within a dtype: per call with time_ms (three rounds:
    the per-call times show the host path wherever it outlasts the
    L2-evicting write, so they swing with the host's load), on the host
    with host_ms, and on the device with device_ms after every other
    timing; -> {dtype: {"<name>_ms", "<name>_host_ms", "<name>_device_ms"}},
    the medians over the turns."""
    rows = {}
    for dtype, fns in timed.items():
        name = str(dtype).split(".")[-1]
        order = list(fns) + list(fns)[::-1]
        ms, host = {k: [] for k in fns}, {k: [] for k in fns}
        for k in order * 3:
            ms[k].append(time_ms(fns[k], 50))
        for k in order:
            host[k].append(host_ms(fns[k]))
        rows[dtype] = row = {}
        for k in fns:
            row[f"{k}_ms"], row[f"{k}_host_ms"] = float(np.median(ms[k])), float(np.median(host[k]))
            print(f"window_sum {name} {k:8s}: per-call ms median {row[f'{k}_ms']:.6f} {ms[k]} "
                  f"host ms median {row[f'{k}_host_ms']:.6f} {host[k]}", flush=True)

    # the L2-evicting write's own device events, over as many calls as the
    # timed runs (a short profile has come back without them)
    flush_kinds = {}
    for _ in range(2):
        flush_kinds.update(device_ms(lambda: None, 200)[1])
    print(f"window_sum: the L2-evicting write's device events {list(flush_kinds)}", flush=True)
    assert flush_kinds, "the profiler recorded no device event of the L2-evicting write"
    skip = frozenset(flush_kinds)
    for dtype, fns in timed.items():
        dev, kinds = {k: [] for k in fns}, {}
        for k in list(fns) + list(fns)[::-1]:
            t, kinds[k] = device_ms(fns[k], 200, skip)
            dev[k].append(t)
            if k != "library":  # its own kernel only, at most once a call
                assert len(kinds[k]) == 1 and list(kinds[k].values())[0] <= 200, (k, kinds[k])
        for k in fns:
            rows[dtype][f"{k}_device_ms"] = float(np.median(dev[k]))
            print(f"window_sum {str(dtype).split('.')[-1]} {k:8s}: device ms median "
                  f"{rows[dtype][f'{k}_device_ms']:.6f} {dev[k]} events per call "
                  f"{json.dumps({n[:90]: c / 200 for n, c in kinds[k].items()})}", flush=True)
    return rows


def phase_window_sum():
    """K3 against its plain version on the micro-benchmark's conv-chain
    output and on edge cases, bf16 and float32; 20 launches bitwise equal;
    per-call, host and device times of K3, torch.sum and the empty kernel
    (window_sum_times); the six variants of the tool with the launch count
    reset before and read after."""
    from deepemia_tpu_torch.kernels import window_sum as ws
    from deepemia_tpu_torch.tools import bench_decouple

    x, convs, _ = bench_decouple.conv_chain(torch.device("cuda"))
    with torch.inference_mode():
        feat = convs(x)
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows, timed = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        f = feat.to(dtype)
        err = check_window_sum("benchmark", f, ws.window_sum(f), ws.VECTOR)
        for tag, e, instance in window_sum_edge_cases(dtype, gen):
            err = max(err, check_window_sum(tag, e, ws.window_sum(e), instance))
        outs = [ws.window_sum(f) for _ in range(20)]
        patterns = torch.cat(outs).view(torch.int32).unique().numel()
        print(f"window_sum {name}: 20 launches, {patterns} bit pattern(s)", flush=True)
        assert patterns == 1, "K3 differs between launches"

        win = f[: ws.WINDOW[0], : ws.WINDOW[1]]
        p_ms = time_ms(lambda: ws.window_sum_plain(f), 50)
        nbytes = win.numel() * win.element_size() + 4
        t_b, t_f = nbytes / HBM_BYTES_PER_S, win.numel() / F32_FLOPS_PER_S
        bound_ms, by = max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")
        rows[dtype] = dict(err=err, plain_ms=p_ms, bound_ms=bound_ms, bound_by=by)
        print(f"window_sum {name}: plain_ms={p_ms:.5f} bound_ms={bound_ms:.3g} ({by}, {nbytes} bytes)",
              flush=True)
        timed[dtype] = {
            "kernel": lambda f=f: ws.window_sum(f),
            "library": lambda win=win: torch.sum(win, dtype=torch.float32),
            "empty": lambda f=f: ws.launch(f, "window_sum_empty"),
        }
    for dtype, times in window_sum_times(timed).items():
        rows[dtype].update(times)
    ws.counter.launches = 0
    variants = bench_decouple.main(device="cuda")
    launches = ws.counter.launches
    print("bench_decouple: " + json.dumps({k: round(v["ms"], 6) for k, v in variants.items()})
          + f" window_sum launches={launches}", flush=True)
    assert launches == 5 * 8 * (2 + 8), launches  # 5 consuming variants x 8 steps x 10 calls
    assert all(math.isfinite(v["value"]) for v in variants.values())
    return rows, launches


def k3_times(root):
    """``python3 chip_smoke.py --k3-times ROOT``: K3 and torch.sum timed by
    window_sum_times through ``window_sum`` of the package in the checkout
    at ROOT (which may be another commit's), at the benchmark's shape
    [256,256,256] of seeded normal values, bf16 and float32, after a check
    against the plain version; prints one JSON line. To compare two
    commits' K3 on one card, run it once for each in one call: parent,
    change, change, parent."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    from deepemia_tpu_torch.kernels import window_sum as ws

    assert ws.__file__.startswith(root + os.sep), ws.__file__
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((256, 256, 256), generator=gen, device="cuda")
    timed = {}
    for dtype in (torch.bfloat16, torch.float32):
        f = x.to(dtype)
        win = f[: ws.WINDOW[0], : ws.WINDOW[1]]
        err = float((ws.window_sum(f) - ws.window_sum_plain(f)).abs().max())
        assert err <= K3_TOL * float(win.float().abs().sum()), err
        timed[dtype] = {
            "kernel": lambda f=f: ws.window_sum(f),
            "library": lambda win=win: torch.sum(win, dtype=torch.float32),
        }
    rows = window_sum_times(timed)
    print(json.dumps({"root": root, **{str(d).split(".")[-1]: r for d, r in rows.items()}}), flush=True)


# ---------------------------------------------------------------------------
# Phase 14: int8 serving (K4) and JPEG input
# ---------------------------------------------------------------------------

INT8_DIR = os.path.join(ROOT, "build", "chip_smoke_int8")
JPEG_FIXTURES = os.path.join(ROOT, "tests", "data", "torch_jpeg_fixtures.npz")
JPEG_QUALITY = 95
# the R50 trunk + FPN conv shapes are captured from one forward of a
# 16-tile batch of 1024² inputs and one 2048² whole-image pass
INT8_TILE, INT8_BATCH, INT8_WHOLE = 1024, 16, 2048
I8_TOPS = 1979e12  # H100 SXM dense int8 tensor-core rate
# detections of the float and the int8 engines matched as INT8_AP.md
# counts them: box IoU > 0.85, the same class, greedy in score order
MATCH_IOU = 0.85

def write_jpeg(path: str, image: np.ndarray, quality: int = JPEG_QUALITY, sampling=(1, 1)) -> None:
    with open(path, "wb") as f:
        f.write(jpeg_encode(image, quality, sampling))


def timed_jpeg(image: np.ndarray, quality: int, sampling) -> tuple:
    """``jpeg_encode`` in a worker process -> (the file, its seconds)."""
    t0 = time.perf_counter()
    data = jpeg_encode(image, quality, sampling)
    return data, time.perf_counter() - t0


def host_pool(workers: int):
    """Spawned worker processes for host file writers (numpy encoders)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    return ProcessPoolExecutor(max_workers=workers, mp_context=multiprocessing.get_context("spawn"))


def start_jpeg_encodes(pool, size: int = 2048):
    """Phase 14's ``size``² micrograph as gray and as colour 4:4:4, 4:2:2
    and 4:2:0 JPEG, encoded by ``timed_jpeg`` in ``pool``; ``main`` starts
    them ahead of the phase. -> [(tag, image, future)]."""
    gray = synthetic_micrograph(size, 7)[..., 0]
    colour = np.stack([gray, np.clip(gray.astype(np.int16) + 25, 0, 255).astype(np.uint8), gray], -1)
    forms = (("gray", gray, (1, 1)), ("4:4:4", colour, (1, 1)), ("4:2:2", colour, (2, 1)), ("4:2:0", colour, (2, 2)))
    return [(tag, img, pool.submit(timed_jpeg, img, JPEG_QUALITY, sampling)) for tag, img, sampling in forms]


def phase_jpeg_fixtures(size: int = 2048, encodes=None):
    """Phase 14: the committed JPEG fixtures (``python
    tools/make_torch_jpeg_fixtures.py``: OpenCV's and PIL's files beside
    the arrays ``cv2.imread`` returns) decode to those arrays bit for bit;
    then a ``size``² micrograph written by ``jpeg_encode`` (the four forms
    at once, in worker processes: ``encodes`` as ``start_jpeg_encodes``
    started them, else started here) as gray and as colour 4:4:4, 4:2:2
    and 4:2:0 decodes within JPEG's own error, and the host decode seconds
    of each."""
    from deepemia_tpu_torch.ops.image import read_image

    os.makedirs(INT8_DIR, exist_ok=True)
    fixtures = np.load(JPEG_FIXTURES)
    names = sorted(k for k in fixtures.files if not k.endswith(".jpg"))
    assert len(names) == 6, names
    for name in names:
        path = os.path.join(INT8_DIR, f"{name}.jpg")
        with open(path, "wb") as f:
            f.write(fixtures[f"{name}.jpg"].tobytes())
        got = read_image(path)
        assert got.shape == fixtures[name].shape and np.array_equal(got, fixtures[name]), name
    print(f"jpeg: {len(names)} committed fixtures ({', '.join(names)}) decode bit for bit to OpenCV's arrays",
          flush=True)
    if encodes is None:
        with host_pool(4) as pool:
            encoded = [(tag, img, *job.result()) for tag, img, job in start_jpeg_encodes(pool, size)]
    else:
        encoded = [(tag, img, *job.result()) for tag, img, job in encodes]
    rows = {}
    for tag, img, data, enc in encoded:
        path = os.path.join(INT8_DIR, f"decode_{tag.replace(':', '')}.jpg")
        with open(path, "wb") as f:
            f.write(data)
        secs = []
        for _ in range(3):
            t0 = time.perf_counter()
            got = read_image(path)
            secs.append(time.perf_counter() - t0)
        want = img if img.ndim == 3 else np.repeat(img[..., None], 3, axis=2)
        err = np.abs(got.astype(np.int16) - want).astype(np.float64)
        psnr = 10 * np.log10(255.0 ** 2 / max(float((err ** 2).mean()), 1e-12))
        assert got.shape == want.shape and psnr > 30, (tag, psnr)
        rows[tag] = float(np.median(secs))
        print(f"jpeg: decode {size}x{size} {tag} (quality {JPEG_QUALITY}, {os.path.getsize(path)} bytes, written by "
              f"jpeg_encode in {enc:.2f} s): {rows[tag]:.4f} s (median of 3, host), PSNR {psnr:.1f} dB", flush=True)
    return rows


def conv_work(x_shape, w_shape, stride, padding, out_dtype, residual=False, with_max=False):
    """(bound ms, 'bytes' or 'operations') of one int8 conv: 2 ops a
    multiply-add over 1,979 TOPS; the int8 activations and weights read
    once, the output written once, the per-image and per-channel maxima
    read once, and where the epilogue takes them the residual (the
    output's size) read once and the per-image max written once, over
    3.35 TB/s."""
    from deepemia_tpu_torch.kernels.int8_conv import conv_out_hw

    n, ci, h, w = x_shape
    co, kh, kw, _ = w_shape
    ho, wo = conv_out_hw(h, w, (kh, kw), stride, padding)
    ops = 2.0 * n * ho * wo * co * kh * kw * ci
    out_bytes = n * ho * wo * co * torch.empty((), dtype=out_dtype).element_size()
    nbytes = (n * ci * h * w + co * kh * kw * ci + (n + co) * 4 + out_bytes * (2 if residual else 1)
              + (4 * n if with_max else 0))
    t_ops, t_bytes = ops / I8_TOPS, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def k4_outputs(result):
    """K4's (output, max or None) from a wrapper's result (a tuple where
    ``with_max``)."""
    return result if isinstance(result, tuple) else (result, None)


def epilogue_name(fused, bias):
    """The epilogue of a captured K4 call, as the int8_conv lines print it."""
    parts = [p for p, on in (("norm", fused.get("norm_weight") is not None),
                             ("residual", fused.get("residual") is not None), ("relu", fused.get("relu")))
             if on] or (["bias"] if bias is not None else ["none"])
    return "+".join(parts) + (", max" if fused.get("with_max") else "")


class ConvCapture:
    """Within the block, the first call of every distinct int8 conv shape
    (N, Ci, H, W, Co, k, stride of the replaced conv, whether it adds a
    residual, whether it takes the max) that the model's forwards make to
    K4's wrapper, with the arguments the module passes (K5's int8 input,
    the weights and stride K4 reads: the stem's space-to-depth form
    included, the epilogue), and how many convs of each shape one forward
    runs, in the trunk and in the FPN; and the first input of every
    distinct shape the activation quantizer (K5) takes (N, C, H, W,
    channels, space-to-depth, whether it comes with its producer's max),
    with that max and how many quantizations of it one forward makes."""

    def __init__(self, model):
        from deepemia_tpu_torch.models.quant import Int8Conv2d

        self.model, self.cls = model, Int8Conv2d
        self.inputs, self.counts, self.handles = {}, {}, []
        self.quant_inputs, self.quant_counts, self.patched = {}, {}, []
        self.current = None

    def __enter__(self):
        from deepemia_tpu_torch.models import quant
        from deepemia_tpu_torch.models.resnet import ActivationMax

        for name, mod in self.model.named_modules():
            if not isinstance(mod, self.cls):
                continue

            def hook(m, args, kwargs, name=name):
                x = args[0].x if isinstance(args[0], (quant.QuantizedActivation, ActivationMax)) else args[0]
                key = (x.shape[0], x.shape[1], x.shape[2], x.shape[3], m.weight_q.shape[0], m.weight_q.shape[1],
                       m.stride, kwargs.get("residual") is not None, bool(kwargs.get("with_max")))
                part = "fpn" if ".fpn_" in name else "trunk"
                self.counts.setdefault(key, {"trunk": 0, "fpn": 0})[part] += 1
                self.current = (key, name, m, x)

            self.handles.append(mod.register_forward_pre_hook(hook, with_kwargs=True))

            def counted(x, part="fpn" if ".fpn_" in name else "trunk", mod=mod, real=mod.quantize):
                q = real(x)
                x, amax = x if isinstance(x, ActivationMax) else (x, None)
                key = (x.shape[0], x.shape[1], x.shape[2], x.shape[3], q.x_q.shape[1], mod.space_to_depth,
                       amax is not None)
                self.quant_counts.setdefault(key, {"trunk": 0, "fpn": 0})[part] += 1
                self.quant_inputs.setdefault(key, (x.contiguous(memory_format=torch.channels_last), amax))
                return q

            mod.quantize = counted  # the block's shared quantization calls it too
            self.patched.append(mod)
        self.real_conv = quant.int8_conv2d

        def conv(x_q, w, scale, bias, stride, padding, out_dtype, **fused):
            key, name, m, x = self.current
            if key not in self.inputs:
                self.inputs[key] = dict(x=x, x_q=x_q, w=w, scale=scale, bias=bias, stride=stride, padding=padding,
                                        fused=fused, name=name, conv_w=m.weight_q, conv_stride=m.stride,
                                        conv_padding=m.padding)
            return self.real_conv(x_q, w, scale, bias, stride, padding, out_dtype, **fused)

        quant.int8_conv2d = conv
        return self

    def __exit__(self, *exc):
        from deepemia_tpu_torch.models import quant

        quant.int8_conv2d = self.real_conv
        for mod in self.patched:
            del mod.quantize
        for h in self.handles:
            h.remove()


def quant_work(x_shape, q_shape, dtype):
    """(bound ms, 'bytes') of one activation quantization: the input read
    once, the int8 output (in the layout K4 reads, its zero channels
    included) and the per-image max written once, over 3.35 TB/s (the same
    for the one pass, which reads the producer's max instead)."""
    nbytes = math.prod(x_shape) * torch.empty((), dtype=dtype).element_size() + math.prod(q_shape) + 4 * x_shape[0]
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def int8_inputs(images):
    """A batch of INT8_BATCH tiles of INT8_TILE² cut from the corners of
    the micrographs (each twice the tile), as the engine feeds the trunk:
    [N,H,W,3] float32 on the card."""
    n_tiles, tile = INT8_BATCH, INT8_TILE
    img = torch.stack([torch.as_tensor(i) for i in images]).cuda().float()
    tiles = [img[k % len(images), (k // 2 % 2) * tile: (k // 2 % 2 + 1) * tile, (k % 2) * tile: (k % 2 + 1) * tile]
             for k in range(n_tiles)]
    return torch.stack(tiles)


K4_EDGE_SHAPES = (  # (N, Ci, H, W, Co, k, stride, padding, residual, with_max): tiles over three or more images
    (5, 64, 6, 7, 256, 1, 1, 0, True, True),
    (3, 64, 9, 11, 64, 3, 1, 1, False, True),
    (7, 128, 5, 5, 512, 1, 1, 0, True, True),
)


def k4_edge_cases(device="cuda"):
    """K4 with the residual and the max against its plain version where a
    128-row tile spans three or more images (maps below 128 pixels, which
    the captured shapes never reach), in both dtypes: diff 0, maxima equal.
    -> the max abs diff."""
    from deepemia_tpu_torch.kernels import int8_conv as k4

    gen = torch.Generator(device=device).manual_seed(5)
    errs = []
    for n, ci, h, w, co, k, stride, pad, residual, with_max in K4_EDGE_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            x_q = torch.randint(-127, 128, (n, h, w, ci), generator=gen, device=device, dtype=torch.int8)
            x_q = x_q.permute(0, 3, 1, 2)
            w_q = torch.randint(-127, 128, (co, k, k, ci), generator=gen, device=device, dtype=torch.int8)
            scale = k4.DequantScale(torch.rand(n, generator=gen, device=device) * 20 + 0.1,
                                    torch.rand(co, generator=gen, device=device) + 0.01)
            nw = torch.rand(co, generator=gen, device=device) + 0.5
            nb = torch.randn(co, generator=gen, device=device)
            ho, wo = k4.conv_out_hw(h, w, (k, k), stride, pad)
            res = None
            if residual:
                res = torch.randn((n, ho, wo, co), generator=gen, device=device).to(dtype).permute(0, 3, 1, 2)
            fused = dict(norm_weight=nw, norm_bias=nb, relu=True, residual=res, with_max=with_max)
            got, amax = k4_outputs(k4.launch(x_q, w_q, scale, None, stride, pad, dtype, **fused))
            want, amax_ref = k4_outputs(k4.int8_conv2d_plain(x_q, w_q, scale, None, stride, pad, dtype, **fused))
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            assert err == 0.0 and torch.equal(amax, amax_ref), (n, ci, h, w, co, dtype, err)
            errs.append(err)
    print(f"int8_conv: K4 with the residual and the max equals its plain version where a tile spans three or "
          f"more images ({len(K4_EDGE_SHAPES)} shapes x bf16, f32; max abs diff {max(errs)}, maxima equal)",
          flush=True)
    return max(errs)


def trunk_breakdown(model, x, n=5):
    """One int8 trunk forward (``bottom_up``) of ``x`` split by the
    profiler's device time into K4, K5's one pass, K5's two passes (its
    max pass and the quantize pass after it), the memsets that zero K4's
    max slots, and the other torch ops; the launches of K4 and K5 a
    forward (the wrappers' counts); and the forward's seconds on the host
    clock (median of ``n``)."""
    from torch.profiler import ProfilerActivity, profile

    from deepemia_tpu_torch.kernels import int8_conv as k4
    from deepemia_tpu_torch.kernels import int8_quant as k5

    trunk = model.backbone.bottom_up
    xn = model.normalize(x)
    trunk(xn)
    k4.counter.launches = k5.counter.launches = 0
    _, wall = sync_time(lambda: trunk(xn))
    launches = {"int8_conv": k4.counter.launches, "int8_quant": k5.counter.launches}
    walls = [wall] + [sync_time(lambda: trunk(xn))[1] for _ in range(n - 1)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            trunk(xn)
        torch.cuda.synchronize()
    split = {"k4_ms": 0.0, "k5_one_pass_ms": 0.0, "k5_two_pass_ms": 0.0, "memset_ms": 0.0, "other_ms": 0.0}
    names = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.self_device_time_total <= 0 or e.is_user_annotation:
            continue
        key = ("k4_ms" if "int8_conv_kernel" in e.key else "k5_one_pass_ms" if "quant_producer_max_kernel" in e.key
               else "k5_two_pass_ms" if "amax_kernel" in e.key or "quant_kernel" in e.key
               else "memset_ms" if "memset" in e.key.lower() else "other_ms")
        split[key] += e.self_device_time_total / 1e3 / n
        if key == "other_ms":
            names[e.key[:60]] = round(e.self_device_time_total / 1e3 / n, 4)
    split["device_ms"] = sum(split.values())
    split["wall_ms"] = float(np.median(walls)) * 1e3
    return split, launches, names


def phase_int8_conv(images):
    """Phase 14: K4 against its plain version on the card at every distinct
    conv shape of the R50 trunk and FPN (``quantized_inference: full``
    captures both), from one forward of a 16-tile batch of 1024² inputs and
    one 2048² whole-image pass, in bf16 and float32, with the fused
    epilogue off (dequantize and bias) and on (the conv's own frozen norm
    and ReLU; each bottleneck's conv3 with its shortcut as the residual;
    the per-image max of every conv1, conv2 and conv3 output), with the
    scale the module hands it (the maxima) and as a table: max abs diff 0,
    maxima equal; K4 where a tile spans three or more images
    (``k4_edge_cases``); and K5 against its plain version (the module's
    torch-op quantizer, then the layout) at every input shape the quantizer
    takes there, the stem's space-to-depth layout included, by its one pass
    (the producer's max, which must equal the max the plain version takes
    of the input) and its two passes: equal. At the 16-tile batch in bf16 it
    times each conv shape (CUDA events after an L2-evicting write): K4 with
    the conv's epilogue, its plain version, bf16 ``F.conv2d`` at the same
    shape and, at the 1x1 stride-1 shapes, ``torch._int_mm`` on the same
    int8 operands (the int32 product alone), and K4's device time
    (``device_ms``, the profiler's) and host time per call (``host_ms``);
    and each quantizer input shape: K5, its plain version and the torch-op
    chain alone (``_quantize_activation``), and K5's device time. Then one
    ``trunk`` forward's K4 and K5 launches (53 and 51: 47 inputs in one
    pass, 2 in two) and ``full``'s (61 and 63), and the profiler's split of
    its device time (``trunk_breakdown``); the trunk + FPN seconds of one
    16-tile batch in bf16 for ``none``, ``trunk`` and ``full``, and the
    detections of the float and int8 engines on one micrograph matched as
    INT8_AP.md counts them. -> (rows of the timed conv shapes, K4's max
    error, per-forward sums, batch seconds, rows of the timed quantizer
    shapes, K5's max error, its per-forward sums, the trunk's split)."""
    import torch.nn.functional as F

    from deepemia_tpu_torch.kernels import int8_conv as k4
    from deepemia_tpu_torch.kernels import int8_quant as k5
    from deepemia_tpu_torch.models import quant
    from deepemia_tpu_torch.models.mask_rcnn import build_model

    batch = int8_inputs(images)
    whole = torch.as_tensor(images[0]).cuda().float()[None]
    captured = {}
    for dtype in (torch.bfloat16, torch.float32):
        model = build_model("R50", num_classes=2, use_bf16=dtype == torch.bfloat16, device="cuda", seed=0,
                            quant_backbone="full")
        for tag, x in (("batch", batch), ("whole", whole)):
            with ConvCapture(model) as cap:
                feats = model.features_batched(x)
            assert all(bool(torch.isfinite(v).all()) for v in feats.values())
            captured[(dtype, tag)] = cap
        del model, feats
    errs, rows, qerrs, qrows = [k4_edge_cases()], [], [], []
    # the L2-evicting write's own device events, left out of device_ms (as window_sum_times does)
    flush_kinds = {}
    for _ in range(2):
        flush_kinds.update(device_ms(lambda: None, 100)[1])
    assert flush_kinds, "the profiler recorded no device event of the L2-evicting write"
    skip = frozenset(flush_kinds)
    n_residual = {}
    for (dtype, tag), cap in captured.items():
        assert sum(c["trunk"] for c in cap.counts.values()) == 53 and sum(c["fpn"] for c in cap.counts.values()) == 8
        # 53 trunk convs read 49 quantized inputs: each stage's first block quantizes once for conv1 and shortcut;
        # all but the stem's image and the max-pool output come with their producer's max
        assert sum(c["trunk"] for c in cap.quant_counts.values()) == 49, cap.quant_counts
        assert sum(c["trunk"] for k_, c in cap.quant_counts.items() if not k_[6]) == 2, cap.quant_counts
        assert sum(c["trunk"] for k_, c in cap.counts.items() if k_[7]) == 16, cap.counts  # the 16 conv3s
        n_residual[f"{str(dtype).split('.')[-1]} {tag}"] = sum(1 for k_ in cap.inputs if k_[7])
        for key, a in cap.inputs.items():
            args = (a["x_q"], a["w"], a["scale"], a["bias"], a["stride"], a["padding"], dtype)
            assert isinstance(a["scale"], k4.DequantScale), type(a["scale"])  # the maxima, made into the scale by K4
            for fused in ({"out_hw": a["fused"]["out_hw"]}, a["fused"]):
                got, amax = k4_outputs(k4.launch(*args, **fused))
                want, amax_ref = k4_outputs(k4.int8_conv2d_plain(*args, **fused))
                torch.cuda.synchronize()
                assert got.shape == want.shape and got.is_contiguous(memory_format=torch.channels_last)
                err = float((got.float() - want.float()).abs().max())
                errs.append(err)
                assert err == 0.0, (key, dtype, tag, bool(fused), err)
                assert (amax is None) == (amax_ref is None) and (amax is None or torch.equal(amax, amax_ref)), (
                    key, dtype, tag, amax, amax_ref)
            table = (a["x_q"], a["w"], a["scale"].table()) + args[3:]  # the same scale as a [N,Co] table
            assert torch.equal(k4_outputs(k4.launch(*table, **a["fused"]))[0], got), (key, dtype, tag)
            if dtype != torch.bfloat16 or tag != "batch":
                continue
            n, ci, h, w, co, k, stride, residual, with_max = key
            # the replaced conv's work (the stem's 3 channels and 7x7 taps, not its space-to-depth form)
            bound, by = conv_work(a["x"].shape, a["conv_w"].shape, stride, a["conv_padding"], dtype, residual,
                                  with_max)
            fused = a["fused"]
            row = dict(shape=f"{n}x{ci}x{h}x{w} -> {co}, {k}x{k}/{stride}", layer=a["name"],
                       count_trunk=cap.counts[key]["trunk"], count_fpn=cap.counts[key]["fpn"],
                       epilogue=epilogue_name(fused, a["bias"]),
                       ms=time_ms(lambda args=args, fused=fused: k4.launch(*args, **fused)),
                       plain_ms=time_ms(lambda args=args, fused=fused: k4.int8_conv2d_plain(*args, **fused), reps=3),
                       bound_ms=bound, bound_by=by)
            row["device_ms"], kinds = device_ms(lambda args=args, fused=fused: k4.launch(*args, **fused), 50, skip)
            # K4's kernel alone, and the memset of the max's slots where it takes the max
            assert sum("int8_conv_kernel" in k_ for k_ in kinds) == 1 and len(kinds) <= 1 + with_max, kinds
            row["host_ms"] = host_ms(lambda args=args, fused=fused: k4.launch(*args, **fused), 200)
            w_bf16 = a["conv_w"].permute(0, 3, 1, 2).to(dtype).contiguous(memory_format=torch.channels_last)
            row["bf16_conv_ms"] = time_ms(lambda a=a, wb=w_bf16: F.conv2d(a["x"], wb, None, a["conv_stride"],
                                                                          a["conv_padding"]))
            row["int_mm_ms"] = None
            if k == 1 and stride == 1:
                a2 = a["x_q"].permute(0, 2, 3, 1).reshape(-1, ci)
                b2 = a["w"].reshape(co, ci).t()
                mm = torch._int_mm(a2, b2)
                acc = k4.int8_conv_acc_plain(a["x_q"], a["w"], 1, 0)
                assert torch.equal(mm, acc.permute(0, 2, 3, 1).reshape(-1, co))
                row["int_mm_ms"] = time_ms(lambda a2=a2, b2=b2: torch._int_mm(a2, b2))
            row["share"] = row["bound_ms"] / row["ms"]
            rows.append(row)
            print("int8_conv " + json.dumps({k_: (round(v, 6) if isinstance(v, float) else v)
                                             for k_, v in row.items()}), flush=True)
        for key, (x, amax_in) in cap.quant_inputs.items():
            channels, s2d, one_pass = key[4], key[5], key[6]
            q, amax = k5.launch(x, s2d, amax_in)
            q_ref, amax_ref = k5.int8_quantize_plain(x, s2d)  # its max taken from x
            torch.cuda.synchronize()
            assert q.is_contiguous(memory_format=torch.channels_last) and q.shape[1] == channels, key
            assert torch.equal(q, q_ref) and torch.equal(amax, amax_ref), (key, dtype, tag)
            qerrs.append(max(float((q.int() - q_ref.int()).abs().max()), float((amax - amax_ref).abs().max())))
            if dtype != torch.bfloat16 or tag != "batch":
                continue
            bound, by = quant_work(x.shape, q.shape, dtype)
            blocks = " (2x2 blocks)" if s2d else ""
            qrow = dict(shape=f"{key[0]}x{key[1]}x{key[2]}x{key[3]} -> {tuple(q.shape)}{blocks}",
                        route="one-pass" if one_pass else "two-pass",
                        count_trunk=cap.quant_counts[key]["trunk"], count_fpn=cap.quant_counts[key]["fpn"],
                        ms=time_ms(lambda x=x, s2d=s2d, a_=amax_in: k5.launch(x, s2d, a_)),
                        plain_ms=time_ms(lambda x=x, s2d=s2d: k5.int8_quantize_plain(x, s2d)),
                        torch_chain_ms=time_ms(lambda x=x: quant._quantize_activation(x)),
                        bound_ms=bound, bound_by=by)
            qrow["device_ms"], kinds = device_ms(lambda x=x, s2d=s2d, a_=amax_in: k5.launch(x, s2d, a_), 50, skip)
            assert len(kinds) == (1 if one_pass else 2), kinds  # the quantize pass, after the max pass in two
            qrow["share"] = qrow["bound_ms"] / qrow["ms"]
            qrows.append(qrow)
            print("int8_quant " + json.dumps({k_: (round(v, 6) if isinstance(v, float) else v)
                                              for k_, v in qrow.items()}), flush=True)
    n_shapes = {f"{str(d).split('.')[-1]} {t}": len(c.inputs) for (d, t), c in captured.items()}
    print(f"int8_conv: K4 equals its plain version (max abs diff {max(errs)}, maxima equal) at every shape of the "
          f"R50 trunk + FPN {json.dumps(n_shapes)}, fused epilogue off and on; with the residual at every conv3 "
          f"shape {json.dumps(n_residual)}", flush=True)
    n_quant = {f"{str(d).split('.')[-1]} {t}": [sum(1 for k_ in c.quant_inputs if k_[6]),
                                                 sum(1 for k_ in c.quant_inputs if not k_[6])]
               for (d, t), c in captured.items()}
    print(f"int8_quant: K5 equals its plain version (x_q and amax equal) at every quantized input shape, "
          f"[one-pass, two-pass] shapes {json.dumps(n_quant)}", flush=True)
    sums = {}
    for part in ("trunk", "fpn"):
        for col in ("ms", "plain_ms", "bound_ms", "bf16_conv_ms", "device_ms", "host_ms"):
            sums[f"{part}_{col}"] = sum(r[col] * r[f"count_{part}"] for r in rows)
        sums[f"{part}_int_mm_ms"] = sum(r["int_mm_ms"] * r[f"count_{part}"] for r in rows if r["int_mm_ms"])
        sums[f"{part}_ms_1x1"] = sum(r["ms"] * r[f"count_{part}"] for r in rows if r["int_mm_ms"])
    sums["trunk_ms_residual"] = sum(r["ms"] * r["count_trunk"] for r in rows if "residual" in r["epilogue"])
    sums["trunk_bound_ms_residual"] = sum(r["bound_ms"] * r["count_trunk"] for r in rows
                                          if "residual" in r["epilogue"])
    sums["bound_by"] = "operations" if all(r["bound_by"] == "operations" for r in rows) else "bytes"
    print("int8_conv: one R50 forward of a 16-tile batch of 1024² inputs, bf16, per-shape times x convs of that "
          "shape: " + json.dumps({k_: (round(v, 6) if isinstance(v, float) else v) for k_, v in sums.items()}),
          flush=True)
    qsums = {}
    for part in ("trunk", "fpn"):
        for col in ("ms", "plain_ms", "torch_chain_ms", "bound_ms", "device_ms"):
            qsums[f"{part}_{col}"] = sum(r[col] * r[f"count_{part}"] for r in qrows)
        for route in ("one-pass", "two-pass"):
            tag_ = route.replace("-", "_")
            qsums[f"{part}_ms_{tag_}"] = sum(r["ms"] * r[f"count_{part}"] for r in qrows if r["route"] == route)
            qsums[f"{part}_bound_ms_{tag_}"] = sum(r["bound_ms"] * r[f"count_{part}"] for r in qrows
                                                   if r["route"] == route)
            qsums[f"{part}_inputs_{tag_}"] = sum(r[f"count_{part}"] for r in qrows if r["route"] == route)
    print("int8_quant: one R50 forward of a 16-tile batch of 1024² inputs, bf16, per-shape times x quantizations "
          "of that shape: " + json.dumps({k_: round(v, 6) for k_, v in qsums.items()}), flush=True)
    del captured

    # K4's and K5's launches a forward, the trunk's device time split; trunk + FPN seconds per batch; the
    # engines' detections matched
    nets = {mode: build_model("R50", num_classes=2, use_bf16=True, device="cuda", seed=0, quant_backbone=mode)
            for mode in ("none", "trunk", "full")}
    for mode, want in (("trunk", (53, 51)), ("full", (61, 63))):
        nets[mode].features_batched(batch)
        k4.counter.launches = k5.counter.launches = 0
        nets[mode].features_batched(batch)
        got = (k4.counter.launches, k5.counter.launches)
        assert got == want, (mode, got, want)
        print(f"int8 --quantized {mode}: one forward of a {INT8_BATCH}-tile batch launches K4 {got[0]} times and "
              f"K5 {got[1]} times", flush=True)
    breakdown, launches, others = trunk_breakdown(nets["trunk"], batch)
    assert launches == {"int8_conv": 53, "int8_quant": 51}, launches
    print(f"int8 trunk: one R50 trunk forward of a {INT8_BATCH}-tile batch of {INT8_TILE}² inputs, bf16, device ms "
          f"by kernel (profiler, mean of 5): " + json.dumps({k_: round(v, 4) for k_, v in breakdown.items()})
          + "; other kernels: " + json.dumps(others), flush=True)
    times = {}
    for _ in range(3):  # the last pass is kept
        for mode, net in nets.items():
            _, times[mode] = sync_time(lambda net=net: net.features_batched(batch))
    print(f"int8: trunk + FPN seconds per {INT8_BATCH}-tile batch of {INT8_TILE}² inputs, bf16: "
          + ", ".join(f"{m} {t:.4f}" for m, t in times.items()), flush=True)
    for net in nets.values():
        sane_geometry(net)
    agreement = {mode: engine_agreement(nets["none"], nets[mode], images[0]) for mode in ("trunk", "full")}
    print("int8: detections of the float and int8 engines on one 2048² micrograph matched at box IoU > "
          f"{MATCH_IOU}, same class (INT8_AP.md's count): " + json.dumps(agreement), flush=True)
    return rows, max(errs), sums, times, qrows, max(qerrs), qsums, breakdown


def engine_agreement(float_model, int8_model, image):
    """The default ``TileEngine`` on ``image`` with both models -> the share
    of detections matched (box IoU > MATCH_IOU, same class, greedy in
    float score order) over the larger count, and the counts."""
    from deepemia_tpu_torch.inference.engine import TileEngine, class_settings_from_config
    from deepemia_tpu_torch.ops.boxes import box_iou_matrix

    dets = []
    for net in (float_model, int8_model):
        inst, _ = TileEngine(net, device="cuda").infer(image, class_settings_from_config({}, 2, device="cuda"))
        keep = inst.valid.nonzero().squeeze(1)
        dets.append((inst.boxes[keep].float(), inst.scores[keep].float(), inst.classes[keep]))
    (ba, sa, ca), (bb, sb, cb) = dets
    iou = box_iou_matrix(ba, bb) if len(ba) and len(bb) else torch.zeros((len(ba), len(bb)), device="cuda")
    used = torch.zeros(len(bb), dtype=torch.bool, device="cuda")
    matched = 0
    for i in torch.argsort(-sa, stable=True).tolist():
        cand = (iou[i] > MATCH_IOU) & ~used & (cb == ca[i])
        if bool(cand.any()):
            used[int(torch.argmax(torch.where(cand, iou[i], -1.0)))] = True
            matched += 1
    denom = max(len(ba), len(bb))
    return {"float": len(ba), "int8": len(bb), "matched": matched,
            "share": matched / denom if denom else 1.0}


def phase_int8_trunk_reference(sizes=((256, 256), (253, 259))):
    """Phase 14: the int8 trunk of one tile of each size (h, w) in bf16 on
    the card (K4, K5) against the port's plain int8 trunk on the CPU with
    the same weights and input: the share of bit-equal elements and the
    max abs diff per level, which must be 1.0 and 0 (finite, same shapes).
    The odd size takes the stem's space-to-depth layout over a ragged
    edge and every conv at tiles that end inside an image."""
    from deepemia_tpu_torch.models.mask_rcnn import build_model

    nets = {dev: build_model("R50", num_classes=2, use_bf16=True, device=dev, seed=0, quant_backbone="trunk")
            for dev in ("cuda", "cpu")}
    rows = {}
    for h, w in sizes:
        img = torch.as_tensor(synthetic_micrograph(max(h, w), 11)[:h, :w]).float()[None]
        out = {dev: {k: v.float().cpu() for k, v in net.backbone.bottom_up(net.normalize(img.to(dev))).items()}
               for dev, net in nets.items()}
        rows[(h, w)] = {}
        for lv, g in out["cuda"].items():
            c = out["cpu"][lv]
            assert g.shape == c.shape and bool(torch.isfinite(g).all()), lv
            rows[(h, w)][lv] = {"bit_equal": float((g == c).float().mean()), "max_abs": float((g - c).abs().max()),
                                "max": float(c.abs().max())}
            assert rows[(h, w)][lv]["bit_equal"] == 1.0, (h, w, lv, rows[(h, w)][lv])
        print(f"int8 trunk, one {h}x{w} tile, bf16, card (K4, K5) vs CPU (plain): " + json.dumps(
            {k: {k_: round(v_, 6) for k_, v_ in v.items()} for k, v in rows[(h, w)].items()}), flush=True)
    return rows


def phase_int8_cli(model, images):
    """Phase 14: ``--task inference --quantized trunk``, then ``--quantized
    full``, through the CLI in one process of their own (``cli_child``, the
    two invocations in turn) on phase 9's first micrograph, written as JPEG
    (``jpeg_encode``, gray, quality 95; phase 12 reads the TIFF forms). The
    image processed, its bar read, one overlay, and K4 and K5 launched
    (their counts from zero for each run). -> the K4 and the K5 launches of
    both runs."""
    from deepemia_tpu_torch.ops.image import read_image

    home, folder = cli_home(model, images[:1], name="int8", jpeg=(0,))
    names = sorted(os.listdir(folder))
    assert names[0].endswith(".jpg"), names
    src = draw_scale_bar(images[0][..., 0], BARS[0][0], BARS[0][2])
    got = read_image(os.path.join(folder, names[0]))
    assert got.shape == images[0].shape and float(np.abs(got[..., 0].astype(np.int16) - src).mean()) < 2.0
    launches = k5_launches = 0
    argv = ["--task", "inference", "--dataset_name", "smoke", "--visualize", "--no-download", "--no-upload",
            "--device", "cuda", "--quantized"]
    children, wall, _ = cli_subprocess(home, argv + ["trunk", "::"] + argv + ["full"])
    keep = names
    for mode, child in zip(("trunk", "full"), children):
        res = child["result"]
        assert child["rc"] == 0 and res["processed"] == list(keep) and not res["failed"], res
        meas = read_csv(res["measurements_csv"])
        check_scale_bars(res, meas, list(keep))
        for name in keep:
            assert os.path.exists(os.path.join(res["output_dir"], f"{name}_predictions.png")), name
        assert child["k4_launches"] > 0 and child["k5_launches"] > 0, child
        assert child["launches"] == child["with_rois"], child
        secs = res["seconds_per_image"]
        print(f"int8 cli --quantized {mode}: {len(keep)} images ({', '.join(keep)}) processed, bars read, "
              f"int8_conv launches={child['k4_launches']}, int8_quant launches={child['k5_launches']}, "
              f"roi_align_fwd launches={child['launches']}; "
              f"seconds_per_image first={secs[0]:.4f} steady={[round(x, 4) for x in secs[1:]]}; the process "
              f"(both runs in turn) took {wall:.1f} s", flush=True)
        print(f"int8 cli --quantized {mode}: steady stage seconds per image {json.dumps(child['steady'])}", flush=True)
        launches += child["k4_launches"]
        k5_launches += child["k5_launches"]
    return launches, k5_launches


# ---------------------------------------------------------------------------
# Phase 15: the web panel and the wizard start inference; the encodings
# read_image takes beside the plain ones
# ---------------------------------------------------------------------------

IMAGE_FIXTURES = os.path.join(ROOT, "tests", "data", "torch_image_fixtures.npz")
PANEL_PASSWORD = "smoke panel"
# the panel's and the wizard's task: its exit within this many seconds
TASK_TIMEOUT_S = 600
# panel rows vs phase 12's CLI rows on the same rasters (the same card, the
# same weights): instances matched at mask IoU >= PIPE_MIN_IOU, as PERF.md's
# "CSV agreement" counts them
PANEL_MATCH_SHARE = 0.98


def write_gray_png(path: str, gray: np.ndarray, orientation: int = 1) -> None:
    """An 8-bit gray PNG of ``gray`` stored as the EXIF ``orientation``
    turns it back (5: stored transposed), with an ``eXIf`` chunk (the bare
    TIFF structure) that says so, before the image data; rows filtered
    "Sub"."""
    import struct
    import zlib

    stored = gray.T if orientation == 5 else gray
    assert orientation in (1, 5)
    h, w = stored.shape
    sub = np.concatenate([stored[:, :1], np.diff(stored, axis=1)], axis=1)  # uint8 wraps modulo 256
    raw = np.concatenate([np.ones((h, 1), np.uint8), sub], axis=1).tobytes()

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    exif = b"II*\x00" + struct.pack("<IHHHIHHI", 8, 1, 0x0112, 3, 1, orientation, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                + chunk(b"eXIf", exif) + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def rle8_encode(gray: np.ndarray) -> bytes:
    """[H,W] uint8 -> a BMP RLE8 stream, bottom row first: runs of 3 or
    more equal pixels as encoded pairs (up to 255 a pair), the stretches
    between them in absolute mode (3-255 pixels, padded to 16 bits; a
    stretch's last one or two pixels as encoded pairs), an end of line after
    each row and the end of bitmap after the last."""
    out = bytearray()
    for row in gray[::-1]:
        starts = np.flatnonzero(np.r_[True, row[1:] != row[:-1]])
        lengths = np.diff(np.r_[starts, row.size])
        lit = 0  # the start of the pending literal stretch
        for s, n in zip(starts[lengths >= 3].tolist(), lengths[lengths >= 3].tolist()):
            out += _rle8_literal(row[lit:s])
            for k in range(0, n, 255):
                out += bytes([min(255, n - k), int(row[s])])
            lit = s + n
        out += _rle8_literal(row[lit:])
        out += b"\x00\x00"
    return bytes(out[:-2]) + b"\x00\x01"


def _rle8_literal(px: np.ndarray) -> bytes:
    out = bytearray()
    for k in range(0, px.size, 255):
        part = px[k : k + 255]
        if part.size >= 3:
            out += bytes([0, part.size]) + part.tobytes() + b"\x00" * (part.size & 1)
        else:
            out += b"".join(bytes([1, int(v)]) for v in part)
    return bytes(out)


def write_rle8_bmp(path: str, gray: np.ndarray) -> None:
    """An RLE8 BMP (compression 1) of ``gray`` with a 256-entry gray palette."""
    import struct

    h, w = gray.shape
    data = rle8_encode(gray)
    pal = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 4, axis=1)
    pal[:, 3] = 0
    at = 14 + 40 + pal.size
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 8, 1, len(data), 2835, 2835, 256, 0)
    with open(path, "wb") as f:
        f.write(b"BM" + struct.pack("<IHHI", at + len(data), 0, 0, at) + info + pal.tobytes() + data)


# phase 15's micrographs, phase 9's rasters with their bars: (name, writer)
ENTRY_ENCODINGS = (
    ("micrograph_0.tif", "8-bit palette TIFF (gray ColorMap, 64-row strips)",
     lambda p, g: write_tiff(p, g, rows_per_strip=64, colormap=np.tile(np.arange(256) * 257, (3, 1)))),
    ("micrograph_1.png", "PNG stored transposed, eXIf Orientation 5", lambda p, g: write_gray_png(p, g, 5)),
    ("micrograph_2.bmp", "RLE8 BMP", write_rle8_bmp),
)
# the one of them the panel's and the wizard's tasks read (their rows held to phase 12's for micrograph_1.tif)
ENTRY_TASK_IMAGE = "micrograph_1.png"


def phase_image_fixtures():
    """Phase 15: every committed encoding fixture (``python
    tools/make_torch_image_fixtures.py``: small PNG, TIFF and BMP files in
    the encodings ``read_image`` takes beside the plain ones, each beside
    the array ``cv2.imread`` returns) decodes to that array bit for bit."""
    from deepemia_tpu_torch.ops.image import read_image

    fixtures = np.load(IMAGE_FIXTURES)
    names = sorted(k for k in fixtures.files if "." not in k)
    assert len(names) >= 45, names
    os.makedirs(PIPELINE_DIR, exist_ok=True)
    for name in names:
        (key,) = [k for k in fixtures.files if k.startswith(name + ".")]
        path = os.path.join(PIPELINE_DIR, key)
        with open(path, "wb") as f:
            f.write(fixtures[key].tobytes())
        got = read_image(path)
        assert got.shape == fixtures[name].shape and np.array_equal(got, fixtures[name]), name
        os.remove(path)
    print(f"image fixtures: {len(names)} committed PNG, TIFF and BMP fixtures decode bit for bit to OpenCV's "
          f"arrays ({', '.join(names)})", flush=True)


def entry_home(model, images, config_hook=None):
    """Phase 12's home layout (``cli_home``) under PIPELINE_DIR/entry with
    ``images`` (their bars drawn) in the ENTRY_ENCODINGS; each decoded
    raster must equal the one written; prints the host decode seconds of
    each. -> (home, folder)."""
    from deepemia_tpu_torch.ops.image import read_image

    home, folder = cli_home(model, [], config_hook, name="entry")
    for i, (name, enc, write) in enumerate(ENTRY_ENCODINGS):
        gray = draw_scale_bar(images[i][..., 0], BARS[i][0], BARS[i][2])
        path = os.path.join(folder, name)
        write(path, gray)
        secs = []
        for _ in range(3):
            t0 = time.perf_counter()
            got = read_image(path)
            secs.append(time.perf_counter() - t0)
        assert got.shape == images[i].shape and np.array_equal(got, np.repeat(gray[..., None], 3, axis=2)), name
        print(f"entry points: {name} as {enc} ({os.path.getsize(path)} bytes) decodes to the raster written, "
              f"{gray.shape[0]}x{gray.shape[1]}: {float(np.median(secs)):.4f} s (median of 3, host)", flush=True)
    return home, folder


def task_log(lines, names):
    """The CLI's log lines of one inference task -> (the device line,
    {kernel: launches}, [seconds per image in order])."""
    device = [ln for ln in lines if "Task inference runs on " in ln]
    kernels = [ln for ln in lines if "CUDA kernel launches:" in ln]
    assert device and kernels, "the task logged no device or no kernel launches"
    counts = dict(part.split() for part in kernels[-1].split("CUDA kernel launches:")[1].split(","))
    secs = []
    for name in names:
        hit = [ln for ln in lines if f" {name}: " in ln and " instances, quality " in ln]
        assert hit, f"the task logged no result for {name}"
        secs.append(float(hit[-1].rsplit(", ", 1)[1].rstrip("s")))
    return device[-1].split("Task inference ")[1], {k: int(v) for k, v in counts.items()}, secs


def rows_by_image(rle, meas, name):
    return [r for r in rle if r[0] == name], [r for r in meas if r[-1] == name]


def panel_http(base, path, data=None):
    """-> (status, body bytes) of one request to the panel."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(base + path, data=data, method="POST" if data is not None else "GET")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def phase_panel(home, names, cli_rows):
    """Phase 15: the web panel in this process (``serve("127.0.0.1", 0)``
    on a thread, the admin password set) starts ``--task inference
    --visualize --no-download`` on the home (a wrong password gets 403),
    /status is polled until the task ends with exit code 0, the CSVs are
    fetched through /files and /download and the results through /zip; the
    task ran on the card, and its rows match phase 12's CLI rows for the
    same rasters. -> the task's K1 launches."""
    import csv
    import hashlib
    import io
    import threading
    import urllib.parse
    import zipfile

    import deepemia_tpu_torch.config.config as config_mod
    from deepemia_tpu_torch.gui import server

    saved = {k: os.environ.get(k) for k in ("DEEPEMIA_TPU_HOME", server.PASSWORD_ENV)}
    os.environ["DEEPEMIA_TPU_HOME"] = home
    os.environ[server.PASSWORD_ENV] = hashlib.sha256(PANEL_PASSWORD.encode()).hexdigest()
    config_mod._default_store = None
    httpd = server.serve("127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        form = {"task": "inference", "dataset": "smoke", "flags": "--visualize --no-download"}
        code, body = panel_http(base, "/run", urllib.parse.urlencode({**form, "password": "wrong"}).encode())
        assert code == 403 and json.loads(body) == {"error": "invalid password"}, (code, body)
        t0 = time.perf_counter()
        code, body = panel_http(base, "/run", urllib.parse.urlencode({**form, "password": PANEL_PASSWORD}).encode())
        assert code == 200 and json.loads(body) == {"ok": True}, (code, body)
        polls = 0
        while True:
            status = json.loads(panel_http(base, "/status")[1])
            polls += 1
            if not status["running"] and status["history"]:
                break
            assert time.perf_counter() - t0 < TASK_TIMEOUT_S, "the panel's task did not end"
            time.sleep(1.0)
        wall = time.perf_counter() - t0
        lines = list(server.RUNNER.output_tail)
        if status["history"][-1]["rc"] != 0:
            print("\n".join(lines[-60:]), file=sys.stderr, flush=True)
            raise AssertionError(f"the panel's task exited {status['history'][-1]['rc']}")
        device, launches, secs = task_log(lines, names)
        assert "cuda" in device and "NVIDIA" in device, device
        assert launches["roi_align_fwd"] > 0, launches
        files = json.loads(panel_http(base, "/files")[1])
        csvs = {}
        for want in ("measurements_results.csv", "R50_flip_results.csv"):
            (rel,) = [f for f in files if f.endswith(want)]
            code, body = panel_http(base, "/download?p=" + urllib.parse.quote(rel))
            assert code == 200, (rel, code)
            csvs[want] = list(csv.reader(io.StringIO(body.decode())))
        assert panel_http(base, "/download?p=" + urllib.parse.quote("../../etc/passwd"))[0] == 404
        code, body = panel_http(base, "/zip")
        with zipfile.ZipFile(io.BytesIO(body)) as z:
            zipped = z.namelist()
        assert code == 200 and all(f in zipped for f in files), (code, len(zipped))
        assert all(f"{n}_predictions.png" in files for n in names), files
    finally:
        httpd.shutdown()
        httpd.server_close()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        config_mod._default_store = None
    meas, rle = csvs["measurements_results.csv"], csvs["R50_flip_results.csv"][1:]
    for name in names:
        assert {r[-2] for r in meas[1:] if r[-1] == name} == {BARS[micrograph_index(name)][0].split()[0]}, name
    print(f"panel: /run with a wrong password -> 403; --task inference --visualize --no-download: exit 0 after "
          f"{wall:.1f} s ({polls} /status polls), device '{device}', kernel launches {json.dumps(launches)}; "
          f"/files {len(files)} files, /download of both CSVs, /zip {len(zipped)} entries; "
          f"seconds_per_image first={secs[0]:.2f} steady={secs[1:]}", flush=True)
    cli_rle, cli_meas = cli_rows
    totals = dict(inst=0, n=0, rows=0, m=0)
    for name in names:
        cli_name = f"micrograph_{micrograph_index(name)}.tif"
        a = csv_agreement(*rows_by_image(rle, meas[1:], name), *rows_by_image(cli_rle, cli_meas, cli_name))
        print(f"panel vs phase 12 CLI, {name} vs {cli_name}: " + json.dumps(a), flush=True)
        assert min(a["n_card"], a["n_cpu"]) > 0, a
        assert a["inst"] >= PANEL_MATCH_SHARE, a
        totals["inst"] += a["inst"] * min(a["n_card"], a["n_cpu"])
        totals["n"] += min(a["n_card"], a["n_cpu"])
    print(f"panel vs phase 12 CLI: instances matched {totals['inst'] / totals['n']:.4f} (IoU >= {PIPE_MIN_IOU}; "
          f"limit {PANEL_MATCH_SHARE})", flush=True)
    return launches["roi_align_fwd"]


def phase_wizard(home, names):
    """Phase 15: ``python -m deepemia_tpu_torch.cli.wizard`` in its own
    process, from the home (not the checkout), with scripted answers: "Run
    inference" on the home's dataset with ``--quantized trunk`` and the
    other defaults, then "Exit"; every image processed, every bar read (the
    CSV's scale-bar column), the task on the card, and K4 and K5 launched.
    -> (K1, K4, K5 launches)."""
    import shutil

    from deepemia_tpu_torch.config.config import default_config

    out_dir = default_config(home)["paths"]["output_dir"]
    shutil.rmtree(out_dir, ignore_errors=True)
    path = os.environ.get("PYTHONPATH")
    env = {**os.environ, "DEEPEMIA_TPU_HOME": home, "PYTHONPATH": ROOT + (os.pathsep + path if path else "")}
    answers = "5\nsmoke\n\n\n\n\ntrunk\n7\n"  # Run inference: dataset, verbosity, threshold, ids, bar debug, int8
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "deepemia_tpu_torch.cli.wizard"], input=answers, text=True,
                          capture_output=True, cwd=home, env=env, timeout=TASK_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if proc.returncode != 0 or "Task finished with exit code 0" not in proc.stdout:
        print(proc.stdout[-4000:], proc.stderr[-8000:], sep="\n", file=sys.stderr, flush=True)
        raise AssertionError(f"the wizard exited {proc.returncode}")
    running = [ln for ln in proc.stdout.splitlines() if ln.startswith("Running: ")]
    assert running and running[0].split()[1:5] == [sys.executable, "-m", "deepemia_tpu_torch.cli.main", "--task"]
    assert "--quantized trunk" in running[0], running
    lines = (proc.stdout + proc.stderr).splitlines()
    device, launches, secs = task_log(lines, names)
    assert "cuda" in device and "NVIDIA" in device, device
    assert any(f"All {len(names)} images processed" in ln for ln in lines), "the wizard's task skipped an image"
    assert launches["int8_conv"] > 0 and launches["int8_quant"] > 0 and launches["roi_align_fwd"] > 0, launches
    meas = read_csv(os.path.join(out_dir, "measurements_results.csv"))
    for name in names:
        assert {r[-2] for r in meas[1:] if r[-1] == name} == {BARS[micrograph_index(name)][0].split()[0]}, name
    print(f"wizard: {running[0][len('Running: '):]}: exit 0, the wizard's process took {wall:.1f} s, device "
          f"'{device}', {len(names)} images processed, bars read, kernel launches {json.dumps(launches)}; "
          f"seconds_per_image first={secs[0]:.2f} steady={secs[1:]}", flush=True)
    return launches["roi_align_fwd"], launches["int8_conv"], launches["int8_quant"]


def phase_entry_points(model, images, cli_rows, config_hook=None):
    """Phase 15: the committed encoding fixtures; phase 9's micrographs as
    a palette TIFF, a transposed PNG with its eXIf orientation and an RLE8
    BMP, decoded bit for bit; inference on the transposed PNG
    (ENTRY_TASK_IMAGE) started from the web panel, its rows held to phase
    12's, and from the wizard with ``--quantized trunk``.
    ``config_hook`` edits the home's config.yaml, as phase 12's does. ->
    (K1, K4, K5 launches of both tasks)."""
    phase_image_fixtures()
    home, folder = entry_home(model, images, config_hook)
    names = sorted(os.listdir(folder))
    assert names == [n for n, _, _ in ENTRY_ENCODINGS], names
    # the tasks read one of them: the transposed PNG, which must reach inference turned back
    for name in names:
        if name != ENTRY_TASK_IMAGE:
            os.remove(os.path.join(folder, name))
    names = [ENTRY_TASK_IMAGE]
    k1 = phase_panel(home, names, cli_rows)
    w1, k4, k5 = phase_wizard(home, names)
    return k1 + w1, k4, k5


# phase 16: two shards, two ensemble members and two training ranks on the one card
TWO_ON_ONE = ["cuda:0", "cuda:0"]
# the 2-rank training step vs one process, float32 with TF32 off: every
# weight within RANKS_TOL of the step's largest update. The ranks add their
# gradients in another order, and at step 1's rate the update is ~1e-5 of
# a weight, so a last-bit difference in a gradient rounds the new weight
# to the neighbouring float: one ulp near 1/32, 2^-29, is 9.68e-5 of this
# step's largest update (the check prints the gap in ulps and beyond one)
RANKS_TOL = 1e-3
RANKS_DIR = os.path.join(ROOT, "build", "chip_smoke_ranks")


def hold_instances(tag, got, ref):
    """Phase 3's checks on ``got`` and the one-device engine's detections
    ``ref`` held to it as phase 5 holds the card's to the CPU's: the same
    valid set and classes, boxes within 1e-2 px, scores within 1e-4, mask
    probabilities within 1e-3. -> whether every tensor is bit-equal."""
    check_instances(got, ref.capacity)
    rv = ref.valid
    assert int(rv.sum()) > 0 and torch.equal(got.valid, rv), f"{tag}: valid sets differ"
    assert torch.equal(got.classes[rv], ref.classes[rv]), f"{tag}: classes differ"
    db = float((got.boxes[rv].float() - ref.boxes[rv].float()).abs().max())
    ds = float((got.scores[rv].float() - ref.scores[rv].float()).abs().max())
    dm = float((got.mask_probs[rv].float() - ref.mask_probs[rv].float()).abs().max())
    equal = all(torch.equal(a, b) for a, b in zip(got, ref))
    print(f"{tag}: valid {int(rv.sum())}, max |d box|={db:.3g} px |d score|={ds:.3g} |d mask|={dm:.3g}, "
          f"bit-equal={equal}", flush=True)
    assert db <= 1e-2 and ds <= 1e-4 and dm <= 1e-3, (tag, db, ds, dm)
    return equal


def phase_sharded_serving(model, image, card):
    """Phase 16 (a): phase 3's serving model on one 2048² micrograph through
    ``TileEngine(device=[cuda:0, cuda:0])`` (its two 16-tile chunks on two
    shard threads, one replica), then the same with ``--quantized trunk``;
    each held to the one-device engine (``hold_instances``) with the
    launches of one sharded image counted from zero (K1 box + mask stage of
    the whole-image pass and of each chunk; K4 and K5 of three trunk
    forwards in int8) and both engines timed. -> (K1, K4, K5 launches)."""
    from deepemia_tpu_torch.inference.engine import TileEngine, class_settings_from_config
    from deepemia_tpu_torch.kernels import int8_conv, int8_quant
    from deepemia_tpu_torch.kernels.roi_align import counter
    from deepemia_tpu_torch.models.mask_rcnn import build_model

    t_start = time.perf_counter()
    settings = class_settings_from_config({}, 2, device="cuda")
    int8 = build_model("R50", num_classes=2, use_bf16=True, device="cuda", seed=0, quant_backbone="trunk")
    sane_geometry(int8)
    launches = {"k1": 0, "k4": 0, "k5": 0}
    for label, net, per_forward in (("bf16", model, (0, 0)), ("--quantized trunk", int8, (53, 51))):
        one, two = TileEngine(net), TileEngine(net, device=TWO_ON_ONE)
        assert len(two.replicas) == 1 and two.devices == [torch.device("cuda", 0)] * 2
        secs = {"one device": [], "two shards": []}
        for _ in range(3):  # the first turn warms up
            for tag, eng in (("one device", one), ("two shards", two)):
                (inst, _), dt = sync_time(lambda eng=eng: eng.infer(image, settings))
                secs[tag].append(dt)
        ref, _ = one.infer(image, settings)
        counter.launches = int8_conv.counter.launches = int8_quant.counter.launches = 0
        got, _ = two.infer(image, settings)
        torch.cuda.synchronize()
        k1, k4, k5 = counter.launches, int8_conv.counter.launches, int8_quant.counter.launches
        chunks = math.ceil(25 / two.tile_batch)
        print(f"sharded serving, {label}: {image.shape[0]}x{image.shape[1]}, {chunks} chunks of {two.tile_batch} "
              f"tiles on {TWO_ON_ONE}; launches of one image roi_align_fwd={k1} int8_conv={k4} int8_quant={k5}; "
              f"seconds per image (turns 2-3) one device {[round(x, 4) for x in secs['one device'][1:]]}, "
              f"two shards {[round(x, 4) for x in secs['two shards'][1:]]} ({card})", flush=True)
        assert k1 == 2 * (1 + chunks), (k1, chunks)
        assert (k4, k5) == (per_forward[0] * (1 + chunks), per_forward[1] * (1 + chunks)), (k4, k5)
        hold_instances(f"sharded serving, {label}: two shards vs one device", got, ref)
        launches = {"k1": launches["k1"] + k1, "k4": launches["k4"] + k4, "k5": launches["k5"] + k5}
    print(f"phase 16 (a): {time.perf_counter() - t_start:.1f} s", flush=True)
    return launches["k1"], launches["k4"], launches["k5"]


def phase_chips_cli(model, images, ensemble_rows, card):
    """Phase 16 (b): ``--task inference --chips 2`` through the CLI in its
    own process, which sees two GPUs on the one card
    (``$SMOKE_LOCAL_DEVICES``), on phase 11's images, checkpoints and
    default configuration (R101 + R50, bars drawn, uncompressed TIFF): the
    members must run at once on one-device groups, every image processed,
    every multilevel RoIAlign with RoIs launching K1, and the rows held to
    phase 11's, which ran the members in turn: identical, or else
    instances at mask IoU >= 0.95 and rows by value, at least
    PANEL_MATCH_SHARE of each, per image. -> K1 launches."""
    import yaml

    from deepemia_tpu_torch.models.mask_rcnn import build_model

    t_start = time.perf_counter()
    r101 = build_model("R101", num_classes=2, use_bf16=True, device="cuda", seed=1)
    sane_geometry(r101)
    name = "chips"
    home = os.path.join(PIPELINE_DIR, name)
    cfg, _, _, _ = pipeline_home(name, model, [], r101=r101)
    del r101
    os.makedirs(os.path.join(home, "config"))
    with open(os.path.join(home, "config", "config.yaml"), "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    folder = os.path.join(home, "DATASET", "INFERENCE")
    os.makedirs(folder)
    with open(cfg["paths"]["category_json"], "w") as f:
        json.dump({"smoke": [folder, folder, ["particle", "pore"]]}, f)
    for i, img in enumerate(images):
        write_tiff(os.path.join(folder, f"micrograph_{i}.tif"), draw_scale_bar(img[..., 0], BARS[i][0], BARS[i][2]))
    argv = ["--task", "inference", "--dataset_name", "smoke", "--no-download", "--no-upload", "--chips", "2"]
    t_home = time.perf_counter() - t_start
    child, wall, _ = cli_subprocess(home, argv, {"SMOKE_LOCAL_DEVICES": ",".join(TWO_ON_ONE)})
    res, layout = child["result"], child["layout"]
    names = sorted(os.listdir(folder))
    assert res["processed"] == names and not res["failed"], res
    assert res["members"] == {n: ["R101", "R50"] for n in names}, res["members"]
    assert layout == {"tile_devices": TWO_ON_ONE, "member_parallel": True, "engines": [["cuda:0"], ["cuda:0"]]}, \
        layout
    assert child["launches"] > 0 and child["launches"] == child["with_rois"], \
        "a multilevel RoIAlign of the --chips 2 run did not launch K1"
    meas = read_csv(res["measurements_csv"])
    rle = read_csv(res["rle_csv"])[1:]
    check_scale_bars(res, meas, names)
    ref_rle, ref_meas = ensemble_rows
    same = rle == ref_rle and meas[1:] == ref_meas
    for n in names if not same else []:  # matched row by row only where the CSVs differ
        a = csv_agreement(*rows_by_image(rle, meas[1:], n), *rows_by_image(ref_rle, ref_meas, n))
        print(f"chips 2 vs phase 11, {n}: {json.dumps(a)}", flush=True)
        assert a["inst"] >= PANEL_MATCH_SHARE and a["rows"] >= PANEL_MATCH_SHARE, (n, a)
    secs = res["seconds_per_image"]
    print(f"chips 2: layout {json.dumps(layout)}; rows identical to phase 11's={same}; roi_align_fwd "
          f"launches={child['launches']}; seconds_per_image first={secs[0]:.4f} steady={[round(x, 4) for x in secs[1:]]}"
          f" (phase 11 ran the members in turn); the CLI process took {wall:.1f} s ({card})", flush=True)
    print(f"chips 2: steady stage seconds per image {json.dumps(child['steady'])}", flush=True)
    print(f"phase 16 (b): {time.perf_counter() - t_start:.1f} s (the home {t_home:.1f} s)", flush=True)
    return child["launches"]


def weight_gap(got, ref, largest):
    """Two state dicts' largest difference as a share of the step's
    ``largest`` update, and that difference in float32 ulps of its weight
    (the larger of the two values); the largest difference beyond one ulp,
    as a share of ``largest`` -> (a line naming both tensors, the first
    share, the last)."""
    frac, ulps, beyond = {}, {}, {}
    for k in ref:
        a, b = got[k].float().flatten(), ref[k].float().flatten()
        diff = (a - b).abs()
        top = torch.maximum(a.abs(), b.abs())
        ulp = torch.nextafter(top, torch.full_like(top, math.inf)) - top
        i = int(diff.argmax())
        frac[k], ulps[k] = float(diff[i]) / largest, float(diff[i] / ulp[i])
        beyond[k] = float((diff - ulp).clamp(min=0).max()) / largest
    f, e = max(frac, key=frac.get), max(beyond, key=beyond.get)
    return (f"worst tensor {f} at {frac[f]:.3g} of the largest update ({ulps[f]:.3g} ulp of its weight); "
            f"beyond one ulp: {e} at {beyond[e]:.3g} of the largest update"), frac[f], beyond[e]


def blocks_in_turn_step(batch, cfg, world=2, device="cuda:0"):
    """The ranks' arithmetic without the ranks: one process builds the
    trainer's model as ``train_on_batches`` does, runs each rank's block of
    ``batch`` forward and backward in turn with that block's per-image
    draws, each block's loss scaled by 1/world so the gradients add up to
    the ranks' average, and takes one step -> the state dict after it."""
    from deepemia_tpu_torch.train import trainer as trainer_mod
    from deepemia_tpu_torch.train.losses import maskrcnn_loss

    dev = torch.device(device)
    model = trainer_mod.build_train_model(cfg.backbone, 2, device=dev, seed=cfg.seed)
    trainer_mod._init_weights(model, None, cfg, dev)
    optimizer, scheduler = trainer_mod.make_optimizer([p for p in model.parameters() if p.requires_grad],
                                                      cfg.base_lr, 1, cfg.warmup_iters, cfg.gamma)
    block = cfg.ims_per_batch // world
    for rank in range(world):
        images, gt = trainer_mod.batch_to_device(trainer_mod.shard_batch(batch, rank, world), dev, cfg, ims=block)
        gens = trainer_mod.image_generators(cfg.seed, 0, range(rank * block, (rank + 1) * block), dev)
        (maskrcnn_loss(model, images, gt, generators=gens, **(cfg.loss_caps or {}))["total"] / world).backward()
    trainer_mod.optimizer_step(optimizer, scheduler, cfg.grad_clip_norm)
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def phase_ranks(card):
    """Phase 16 (c): ``train_on_batches`` on two ranks on the one card
    (``devices=[cuda:0, cuda:0]``: two started processes over gloo, since
    NCCL refuses two ranks on one GPU), float32 with TF32 off, one step on
    two 2 x 512² batches' first, against the one-process step on the same
    global batch: every weight within RANKS_TOL of the largest update (the
    gap also read in float32 ulps of the weight; the draws are the
    trainer's per-image ones, the same in both runs), and the blocks
    stepped in turn in one process beside both. Then
    ``--task train --max-iter 3`` through the CLI in its own process, inside
    an NCCL process group of world size 1 (``MASTER_ADDR``, ``RANK``,
    ``WORLD_SIZE`` set, as ``torchrun`` does). -> (K1, K2 launches of the
    one-process step and the CLI's training, the one-process step: its
    weights, losses and largest update, for phase 17 (b))."""
    import shutil

    import yaml

    from deepemia_tpu_torch.config.config import default_config
    from deepemia_tpu_torch.kernels.roi_align import bwd_counter, counter
    from deepemia_tpu_torch.models.mask_rcnn import build_train_model
    from deepemia_tpu_torch.train import trainer as trainer_mod

    t_start = time.perf_counter()
    shutil.rmtree(RANKS_DIR, ignore_errors=True)
    batches = synthetic_train_batches(1, seed=17)
    cfg = trainer_mod.TrainConfig(use_bf16=False, warmup_iters=0, checkpoint_every=1000, log_every=1)
    start = build_train_model("R50", 2, device="cpu", seed=cfg.seed)
    trainer_mod.zero_residual_norms(start)
    start = start.state_dict()
    counter.launches = bwd_counter.launches = 0
    (ref_path, ref_metrics), t_one = sync_time(lambda: trainer_mod.train_on_batches(
        batches, 2, os.path.join(RANKS_DIR, "one"), cfg, max_steps_override=1, device="cuda"))
    k1, k2 = counter.launches, bwd_counter.launches
    assert (k1, k2) == (2, 2), (k1, k2)
    t0 = time.perf_counter()
    path, metrics = trainer_mod.train_on_batches(batches, 2, os.path.join(RANKS_DIR, "two"), cfg,
                                                 max_steps_override=1, devices=TWO_ON_ONE)
    t_two = time.perf_counter() - t0
    ref = torch.load(ref_path, map_location="cpu")["model"]
    got = torch.load(path, map_location="cpu")["model"]
    largest = max(float((ref[k].float() - start[k].float()).abs().max()) for k in ref)
    gap = weight_gap(got, ref, largest)
    print(f"ranks: one step, 2 x 512², float32: two ranks on {TWO_ON_ONE} (gloo) vs one process: largest update "
          f"{largest:.4g}; {gap[0]}; losses "
          f"{json.dumps({k: [round(metrics[k], 6), round(ref_metrics[k], 6)] for k in ('total', 'cls', 'mask')})}; "
          f"wall seconds (process starts included) two ranks {t_two:.1f}, one process {t_one:.1f} ({card})",
          flush=True)
    assert largest > 0 and gap[1] <= RANKS_TOL, gap
    # where the gap comes from: the same blocks in turn in one process
    turn = blocks_in_turn_step(batches[0], cfg)
    for tag, other in (("two ranks", got), ("one process on the global batch", ref)):
        print(f"ranks: the blocks in turn in one process (batch 1 twice) vs {tag}: "
              f"{weight_gap(turn, other, largest)[0]}", flush=True)
    for k in ("total", "rpn_cls", "rpn_loc", "cls", "box", "mask"):
        assert abs(metrics[k] - ref_metrics[k]) <= 1e-4 * max(abs(ref_metrics[k]), 1e-3), (k, metrics, ref_metrics)

    t_step = time.perf_counter() - t_start
    home = os.path.join(RANKS_DIR, "home")
    root = synthetic_dataset(os.path.join(home, "DATASET", "sem"), 4, seed=19)
    dcfg = default_config(home)
    os.makedirs(os.path.join(home, "config"))
    with open(os.path.join(home, "config", "config.yaml"), "w") as f:
        yaml.safe_dump(dcfg, f, sort_keys=False)
    with open(dcfg["paths"]["category_json"], "w") as f:
        json.dump({"sem": [root, root, ["particle", "pore"]]}, f)
    flags = ["--dataset_name", "sem", "--no-download", "--no-upload"]
    assert run_cli(home, "--task", "prepare", *flags) == 0
    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(trainer_mod._free_port()), "RANK": "0", "WORLD_SIZE": "1",
           "LOCAL_RANK": "0"}
    child, wall, proc = cli_subprocess(home, ["--task", "train", "--rcnn", "50", "--max-iter", "3", *flags], env)
    started = [ln for ln in proc.stderr.splitlines() if "torch.distributed started" in ln]
    assert started and "rank 0 of 1 (nccl)" in started[0], proc.stderr[-3000:]
    final = os.path.join(dcfg["paths"]["split_dir"], "sem", "rcnn_r50", "model_final_r50.pt")
    assert os.path.exists(final) and child["k2_launches"] == 2 * 3, child["k2_launches"]
    print(f"ranks: --task train --max-iter 3 in an NCCL process group of world size 1: exit 0, "
          f"'{started[0].split(': ', 1)[-1]}', roi_align_fwd launches={child['launches']} (3 steps and evaluate), "
          f"roi_align_bwd launches={child['k2_launches']}; the CLI process took {wall:.1f} s ({card})", flush=True)
    shutil.rmtree(RANKS_DIR, ignore_errors=True)
    print(f"phase 16 (c): {time.perf_counter() - t_start:.1f} s (the step's part {t_step:.1f} s)", flush=True)
    return k1 + child["launches"], k2 + child["k2_launches"], (ref, ref_metrics, largest)


# phase 17: ranks of a process group on the one card (two ranks share it over
# gloo, since NCCL refuses two ranks on one GPU)
RANK_TIMEOUT_S = 300


def wait_ranks(procs):
    """Wait for the rank processes ``procs``; when one exits nonzero, or at
    RANK_TIMEOUT_S, kill the rest (a rank left alone waits in a collective
    for good)."""
    deadline = time.perf_counter() + RANK_TIMEOUT_S
    try:
        while any(proc.poll() is None for proc in procs):
            if time.perf_counter() > deadline or any(proc.poll() not in (None, 0) for proc in procs):
                break
            time.sleep(0.2)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def cli_ranks(homes, argv, env=None):
    """``cli_child`` in one process a rank, started as ``torchrun`` starts
    them (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``), rank r on ``homes[r]``, its output
    in files (a full pipe would stall a rank inside a collective); every
    rank killed at RANK_TIMEOUT_S -> (each rank's JSON report, the wall
    seconds, each rank's standard error)."""
    from deepemia_tpu_torch.train.trainer import _free_port

    port, world = _free_port(), len(homes)
    procs = []
    t0 = time.perf_counter()
    for r, home in enumerate(homes):
        out_json = os.path.join(home, "child.json")
        log = open(os.path.join(home, "child.log"), "w")
        e = {**os.environ, "DEEPEMIA_TPU_HOME": home, "MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
             "RANK": str(r), "WORLD_SIZE": str(world), "LOCAL_RANK": str(r), "LOCAL_WORLD_SIZE": str(world),
             **(env or {})}
        procs.append((subprocess.Popen(
            [sys.executable, "-c", f"import sys, chip_smoke; sys.exit(chip_smoke.cli_child({out_json!r}, *{argv!r}))"],
            cwd=ROOT, env=e, stdout=log, stderr=subprocess.STDOUT), out_json, log))
    try:
        wait_ranks([proc for proc, _, _ in procs])
    finally:
        for _, _, log in procs:
            log.close()
    wall = time.perf_counter() - t0
    reports, logs = [], []
    for r, (proc, out_json, log) in enumerate(procs):
        with open(log.name) as f:
            logs.append(f.read())
        if proc.returncode != 0 or not os.path.exists(out_json):
            print(logs[-1][-6000:], file=sys.stderr, flush=True)
            raise AssertionError(f"rank {r} of the CLI's {world} exited {proc.returncode}")
        with open(out_json) as f:
            reports.append(json.load(f))
        os.remove(out_json)
        assert reports[-1]["rc"] == 0, (r, reports[-1]["rc"], logs[-1][-4000:])
    return reports, wall, logs


def hold_rows(tag, got, ref, share=PANEL_MATCH_SHARE):
    """``got``'s (RLE, measurement) rows against ``ref``'s: identical, or
    else, image by image, instances at mask IoU >= PIPE_MIN_IOU and rows by
    value, at least ``share`` of each. -> whether they are identical."""
    same = got == ref
    names = sorted({r[0] for r in ref[0]} | {r[0] for r in got[0]})
    for n in names if not same else []:
        a = csv_agreement(*rows_by_image(*got, n), *rows_by_image(*ref, n))
        print(f"{tag}, {n}: {json.dumps(a)}", flush=True)
        assert a["inst"] >= share and a["rows"] >= share, (tag, n, a)
    return same


def phase_rank_inference(model, images, phase12, card):
    """Phase 17 (a): ``--task inference --visualize --id --draw-scalebar``
    through the CLI in two ranks (``cli_ranks``: gloo, both on ``cuda:0``,
    which ``$SMOKE_LOCAL_DEVICES`` shows each rank as its GPU), on phase
    12's three micrographs, home and config, each rank on a home of its
    own: bf16, held to phase 12's one-process rows (``phase12``: its K1
    launches and rows); then, on the first micrograph alone, ``--quantized
    trunk`` in an NCCL group of world size 1 (one process: exit 0) and in
    the two ranks, held to it.
    Rank 1 writes no result; each kernel's per-rank launches add up to the
    one-process run's. -> (K1, K4, K5 launches of the five processes)."""
    import shutil

    t_start = time.perf_counter()
    homes = [cli_home(model, images, name=f"ranks{r}")[0] for r in range(2)]
    argv = ["--task", "inference", "--dataset_name", "smoke", "--visualize", "--id", "--draw-scalebar",
            "--no-download", "--no-upload"]
    two = {"SMOKE_LOCAL_DEVICES": ",".join(TWO_ON_ONE)}
    from deepemia_tpu_torch.train.trainer import _free_port

    one = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port()), "RANK": "0", "WORLD_SIZE": "1",
           "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1"}
    launches = {"k1": 0, "k4": 0, "k5": 0}

    def two_ranks(label, extra, ref_k1, ref_rows, ref_k45):
        reports, wall, logs = cli_ranks(homes, argv + extra, two)
        started = [next(ln for ln in lg.splitlines() if "torch.distributed started" in ln) for lg in logs]
        assert all(f"rank {r} of 2 (gloo)" in ln for r, ln in enumerate(started)), started
        names = sorted(os.listdir(os.path.join(homes[0], "DATASET", "INFERENCE")))
        for r, rep in enumerate(reports):
            res = rep["result"]
            assert res["processed"] == names and not res["failed"], (r, res)
            assert rep["layout"]["tile_devices"] == ["cuda:0", "cuda:0"], rep["layout"]
        res = reports[0]["result"]
        rows = (read_csv(res["rle_csv"])[1:], read_csv(res["measurements_csv"])[1:])
        # the config store makes the (empty) output folder on every rank, as the JAX package's does
        out1 = reports[1]["result"]["output_dir"]
        assert not os.path.exists(out1) or not os.listdir(out1), f"rank 1 wrote results: {os.listdir(out1)}"
        check_scale_bars(res, [[]] + rows[1], names)
        same = hold_rows(f"ranks, {label}", rows, ref_rows)
        per_rank = [(rep["launches"], rep["k4_launches"], rep["k5_launches"]) for rep in reports]
        sums = tuple(map(sum, zip(*per_rank)))
        secs = [rep["result"]["seconds_per_image"] for rep in reports]
        print(f"rank inference, {label}: two ranks (gloo, {TWO_ON_ONE}), {len(names)} images 2048²: rows identical "
              f"to the one-process run's={same}; launches per rank (roi_align_fwd, int8_conv, int8_quant) "
              f"{per_rank}, sums {sums}, one process ({ref_k1}, {ref_k45[0]}, {ref_k45[1]}); rank 1 wrote nothing; "
              f"seconds per image rank 0 {[round(x, 4) for x in secs[0]]} rank 1 {[round(x, 4) for x in secs[1]]}; "
              f"the ranks took {wall:.1f} s ({card})", flush=True)
        assert sums == (ref_k1, *ref_k45), (sums, ref_k1, ref_k45)
        assert all(rep["launches"] == rep["with_rois"] for rep in reports), \
            "a multilevel RoIAlign of a rank did not launch K1"
        for key, i in (("k1", 0), ("k4", 1), ("k5", 2)):
            launches[key] += sums[i]
        shutil.rmtree(res["output_dir"])

    two_ranks("bf16", [], *phase12, (0, 0))
    # the int8 runs on the first micrograph alone
    for home in homes:
        folder = os.path.join(home, "DATASET", "INFERENCE")
        for name in sorted(os.listdir(folder))[1:]:
            os.remove(os.path.join(folder, name))
    single, wall1, proc = cli_subprocess(homes[0], argv + ["--quantized", "trunk"], one)
    started = [ln for ln in proc.stderr.splitlines() if "torch.distributed started" in ln]
    assert started and "rank 0 of 1 (nccl)" in started[0], proc.stderr[-3000:]
    print(f"rank inference: --task inference --quantized trunk in an NCCL process group of world size 1 on "
          f"micrograph_0.tif: exit 0, '{started[0].split(': ', 1)[-1]}', launches roi_align_fwd={single['launches']} "
          f"int8_conv={single['k4_launches']} int8_quant={single['k5_launches']}; the process took {wall1:.1f} s "
          f"({card})", flush=True)
    res1 = single["result"]
    quant_ref = (read_csv(res1["rle_csv"])[1:], read_csv(res1["measurements_csv"])[1:])
    shutil.rmtree(res1["output_dir"])
    for key, got in (("k1", "launches"), ("k4", "k4_launches"), ("k5", "k5_launches")):
        launches[key] += single[got]
    two_ranks("--quantized trunk", ["--quantized", "trunk"], single["launches"], quant_ref,
              (single["k4_launches"], single["k5_launches"]))
    print(f"phase 17 (a): {time.perf_counter() - t_start:.1f} s", flush=True)
    return launches["k1"], launches["k4"], launches["k5"]


def tp_rank_child(out_path: str, out_dir: str) -> int:
    """A launcher's rank on CUDA (``maybe_init_distributed``): which
    collectives gloo takes on CUDA tensors, then ``train_on_batches`` at
    ``n_model_shards=2`` for one float32 step on phase 16 (c)'s batch; writes
    its K1 and K2 launches, losses, the collectives and the weights it held
    (its blocks of fc1 and fc2) to ``out_path``."""
    import torch.distributed as dist

    from deepemia_tpu_torch.kernels.roi_align import bwd_counter, counter
    from deepemia_tpu_torch.train import trainer as trainer_mod
    from deepemia_tpu_torch.utils.device import maybe_init_distributed

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    assert maybe_init_distributed("cuda")
    takes = {}
    t = torch.ones(4, device="cuda")
    for name, call in (("all_reduce", lambda: dist.all_reduce(t.clone())),
                       ("broadcast", lambda: dist.broadcast(t.clone(), src=0)),
                       ("all_gather", lambda: dist.all_gather([torch.empty_like(t) for _ in range(2)], t)),
                       ("gather", lambda: dist.gather(t, [torch.empty_like(t) for _ in range(2)]
                                                      if dist.get_rank() == 0 else None, dst=0))):
        try:
            call()
            torch.cuda.synchronize()
            takes[name] = True
        except RuntimeError as e:
            takes[name] = str(e).splitlines()[0][:200]
    held = {}
    real = trainer_mod.full_state

    def full_state(model, optimizer):
        held.update({k: v.detach().cpu().clone() for k, v in model.state_dict().items()})
        return real(model, optimizer)

    trainer_mod.full_state = full_state
    cfg = trainer_mod.TrainConfig(use_bf16=False, warmup_iters=0, checkpoint_every=1000, log_every=1,
                                  n_model_shards=2)
    counter.launches = bwd_counter.launches = 0
    try:
        t0 = time.perf_counter()
        path, metrics = trainer_mod.train_on_batches(synthetic_train_batches(1, seed=17), 2, out_dir, cfg,
                                                     max_steps_override=1, device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        torch.save({"rank": dist.get_rank(), "k1": counter.launches, "k2": bwd_counter.launches, "path": path,
                    "metrics": metrics, "takes": takes, "held": held, "seconds": secs}, out_path)
    finally:
        dist.destroy_process_group()
    return 0


def phase_tp_training(one_step, card):
    """Phase 17 (b): one float32 training step with ``n_model_shards=2`` on
    two ranks on the one card (data 1 x model 2; ``tp_rank_child`` in two
    processes started as ``torchrun`` starts them, gloo) against phase 16
    (c)'s one-process step on the same global batch: every weight within
    RANKS_TOL of the largest update (the gap also read in ulps), the losses
    to 1e-4; 2 K1 and 2 K2 launches on each rank (each runs its data block
    whole); the checkpoint rank 0 wrote, loaded into one process, equal to
    what each rank held (the whole parameters, and its block of fc1 and
    fc2). -> (K1, K2 launches of both ranks)."""
    import shutil

    from deepemia_tpu_torch.models.heads import block_bounds
    from deepemia_tpu_torch.models.mask_rcnn import build_train_model
    from deepemia_tpu_torch.train.trainer import _free_port

    t_start = time.perf_counter()
    ref, ref_metrics, largest = one_step
    out_dir = os.path.join(RANKS_DIR, "tp")
    os.makedirs(out_dir, exist_ok=True)
    port = _free_port()
    procs = []
    for r in range(2):
        env = {**os.environ, "MASTER_ADDR": "localhost", "MASTER_PORT": str(port), "RANK": str(r), "WORLD_SIZE": "2",
               "LOCAL_RANK": str(r), "LOCAL_WORLD_SIZE": "2"}
        out = os.path.join(RANKS_DIR, f"tp_rank{r}.pt")
        log = open(os.path.join(RANKS_DIR, f"tp_rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", f"import sys, chip_smoke; sys.exit(chip_smoke.tp_rank_child({out!r}, {out_dir!r}))"],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT), out, log))
    try:
        wait_ranks([proc for proc, _, _ in procs])
    finally:
        for _, _, log in procs:
            log.close()
    wall = time.perf_counter() - t_start
    got = []
    for r, (proc, out, log) in enumerate(procs):
        if proc.returncode != 0 or not os.path.exists(out):
            with open(log.name) as f:
                print(f.read()[-6000:], file=sys.stderr, flush=True)
            raise AssertionError(f"tensor-parallel rank {r} exited {proc.returncode}")
        got.append(torch.load(out, map_location="cpu"))
    print(f"tp: gloo's collectives on CUDA tensors (as called, before any staging): {json.dumps(got[0]['takes'])}",
          flush=True)
    full = torch.load(got[0]["path"], map_location="cpu")["model"]
    gap = weight_gap(full, ref, largest)
    metrics = got[0]["metrics"]
    print(f"tp: one step, 2 x 512², float32, data 1 x model 2 on {TWO_ON_ONE} (gloo) vs one process: largest "
          f"update {largest:.4g}; {gap[0]}; losses "
          f"{json.dumps({k: [round(metrics[k], 6), round(ref_metrics[k], 6)] for k in ('total', 'cls', 'box')})}; "
          f"launches per rank (roi_align_fwd, roi_align_bwd) {[(g['k1'], g['k2']) for g in got]}; the step on the "
          f"ranks {[round(g['seconds'], 2) for g in got]} s, wall {wall:.1f} s (process starts included) ({card})",
          flush=True)
    assert gap[1] <= RANKS_TOL, gap
    for k in ("total", "rpn_cls", "rpn_loc", "cls", "box", "mask"):
        assert abs(metrics[k] - ref_metrics[k]) <= 1e-4 * max(abs(ref_metrics[k]), 1e-3), (k, metrics, ref_metrics)
    assert [(g["k1"], g["k2"]) for g in got] == [(2, 2), (2, 2)]
    one = build_train_model("R50", 2, device="cpu")
    one.load_state_dict(full, strict=True)
    loaded = one.state_dict()
    dims = {"roi_heads.box_head.fc1.weight": 0, "roi_heads.box_head.fc2.weight": 1}
    for g in got:
        for k, v in g["held"].items():
            want = loaded[k]
            if k in dims:
                a, b = block_bounds(1024, g["rank"], 2)
                want = want.narrow(dims[k], a, b - a)
            assert torch.equal(v, want), (g["rank"], k)
    print(f"tp: the checkpoint rank 0 wrote loads into one process (strict) and equals what each rank held: fc1 "
          f"rows and fc2 columns {[block_bounds(1024, r, 2) for r in range(2)]}, every other tensor whole", flush=True)
    shutil.rmtree(out_dir, ignore_errors=True)
    print(f"phase 17 (b): {time.perf_counter() - t_start:.1f} s", flush=True)
    return sum(g["k1"] for g in got), sum(g["k2"] for g in got)


# ---------------------------------------------------------------------------
# Phase 18: the image codings read beside the plain ones
# ---------------------------------------------------------------------------

CODINGS_FIXTURES = os.path.join(ROOT, "tests", "data", "torch_codings_fixtures.npz")
CODINGS_DIR = os.path.join(PIPELINE_DIR, "codings_files")
# the arithmetic-coded twins' quality (phase 14 writes at JPEG_QUALITY, whose
# many coefficients would keep the numpy arithmetic coder busy for minutes)
CODINGS_QUALITY = 90
# phase 12's rasters as phase 18 (c) writes them: (TIFF variant, its compression, strips or tiles)
CODINGS_CLI = (("BigTIFF LZW tiles", "bigtiff II", 5, None, (256, 256)),
               ("FillOrder 2 LZW strips", "fill order 2", 5, 64, None),
               ("FillOrder 2 PackBits BigTIFF", "fill order 2 bigtiff MM", 32773, 64, None))
CODINGS_VARIANTS = {"classic": (1, False, False), "fill order 2": (2, False, False),
                    "bigtiff II": (1, True, False), "bigtiff MM": (1, True, True),
                    "fill order 2 bigtiff MM": (2, True, True)}


def codings_task(kind: str, *args):
    """One of phase 18's 2048² files, written in a worker process by the
    numpy writers of ``tools/make_torch_codings_fixtures.py``: "jpeg"
    (image, sampling, coding) -> the file in that coding of the image's
    quantised coefficients; "tiff" (raster, compression, rows per strip,
    tile) -> {variant: file} over CODINGS_VARIANTS, the segments encoded
    once; "fax" (bits, compression, T4Options) -> the bilevel file, 256-row
    strips."""
    if kind == "jpeg":
        image, sampling, coding = args
        return codings.jpeg_encode(image, CODINGS_QUALITY, sampling, coding)
    if kind == "tiff":
        raster, compression, rows, tile = args
        return codings.tiff_variants(raster, compression, CODINGS_VARIANTS, rows, tile)
    bits, compression, options = args
    if compression == 1:  # the plain counterpart: uncompressed bilevel rows
        tags = {256: (codings.LONG, [bits.shape[1]]), 257: (codings.LONG, [bits.shape[0]]),
                258: (codings.SHORT, [1]), 259: (codings.SHORT, [1]), 262: (codings.SHORT, [0]),
                277: (codings.SHORT, [1]), 278: (codings.LONG, [256])}
        rows = np.packbits(bits, axis=1)
        return codings.tiff_bytes(tags, [rows[y : y + 256].tobytes() for y in range(0, bits.shape[0], 256)])
    return codings.fax_tiff(bits, compression, options, rows_per_strip=256)


def decode_seconds(path: str):
    """``read_image(path)`` three times -> (its pixels, the median seconds)."""
    from deepemia_tpu_torch.ops.image import read_image

    secs, img = [], None
    for _ in range(3):
        t0 = time.perf_counter()
        img = read_image(path)
        secs.append(time.perf_counter() - t0)
    return img, float(np.median(secs))


def phase_codings(model, images, phase12, card, size=2048):
    """Phase 18: the codings ``read_image`` reads beside the plain ones.
    (a) the committed fixtures (``tests/data/torch_codings_fixtures.npz``:
    FillOrder 2, BigTIFF, old-style LZW, CCITT fax, arithmetic-coded,
    CMYK/YCCK, block-smoothed and lossless JPEG, 16-bit and OS/2 BMP, each
    beside the array ``cv2.imread`` returns) decode bit for bit; (b) at ``size``², written by this script's
    numpy writers in worker processes: the arithmetic-coded twins
    (sequential and progressive, gray and 4:2:0) of the Huffman file of
    one set of quantised coefficients decode bit-equal to it; phase 12's
    rasters as FillOrder 2 (raw, LZW, PackBits) and BigTIFF (II and MM,
    strips and LZW tiles) decode to the raster; a thresholded micrograph as
    Group 4 and 2D Group 3 decodes to its bits; each file's decode seconds
    beside its plain counterpart's; (c) ``--task inference`` through the
    CLI in its own process (phase 12's argv) on phase 12's rasters written
    as BigTIFF LZW tiles, FillOrder 2 LZW strips and a FillOrder 2 PackBits
    BigTIFF: its rows in both CSVs byte-equal to phase 12's, as many K1
    launches, the device line naming the card. -> the run's K1 launches."""
    import shutil

    from deepemia_tpu_torch.ops.image import read_image

    os.makedirs(CODINGS_DIR, exist_ok=True)
    rasters = [draw_scale_bar(img[..., 0], BARS[i][0], BARS[i][2]) for i, img in enumerate(images)]
    gray = images[0][..., 0]
    colour = np.stack([gray, np.clip(gray.astype(np.int16) + 25, 0, 255).astype(np.uint8), gray], -1)
    bits = (gray < 128).astype(np.uint8)  # the particles
    t0 = time.perf_counter()
    workers = min(8, os.cpu_count() or 1)
    with host_pool(workers) as pool:
        jobs = {}
        for tag, img, sampling in (("gray", gray, (1, 1)), ("4:2:0", colour, (2, 2))):
            for coding in ("arith-progressive", "arith", "huffman"):
                jobs[f"jpeg {coding} {tag}"] = pool.submit(codings_task, "jpeg", img, sampling, coding)
        for i, (_, _, comp, rows, tile) in enumerate(CODINGS_CLI):
            jobs[f"tiff {i}"] = pool.submit(codings_task, "tiff", rasters[i], comp, rows, tile)
        jobs["tiff raw"] = pool.submit(codings_task, "tiff", rasters[0], 1, 64, None)
        for comp, options in ((4, 0), (3, 1), (1, 0)):
            jobs[f"fax {comp} {options}"] = pool.submit(codings_task, "fax", bits, comp, options)
        # (a) while the workers write
        fixtures = np.load(CODINGS_FIXTURES)
        names = sorted(k for k in fixtures.files if "." not in k)
        assert len(names) >= 30, names
        for name in names:
            (key,) = [k for k in fixtures.files if k.startswith(name + ".")]
            path = os.path.join(CODINGS_DIR, key)
            with open(path, "wb") as f:
                f.write(fixtures[key].tobytes())
            got = read_image(path)
            assert got.shape == fixtures[name].shape and np.array_equal(got, fixtures[name]), name
            os.remove(path)
        print(f"codings: {len(names)} committed fixtures decode bit for bit to OpenCV's arrays ({', '.join(names)})",
              flush=True)
        files = {k: j.result() for k, j in jobs.items()}
    print(f"codings: {len(files)} jobs of {size}x{size} files written by the numpy writers in "
          f"{time.perf_counter() - t0:.1f} s ({workers} worker processes, host)", flush=True)

    def write(name, data):
        path = os.path.join(CODINGS_DIR, name)
        with open(path, "wb") as f:
            f.write(data)
        return path

    def report(what, path, secs, plain, plain_secs):
        print(f"codings: decode {what} {size}x{size} ({os.path.getsize(path)} bytes): {secs:.4f} s beside {plain} "
              f"{plain_secs:.4f} s (median of 3, host)", flush=True)

    # (b) the arithmetic-coded twins
    for tag in ("gray", "4:2:0"):
        huff, huff_s = decode_seconds(write(f"huffman_{tag[0]}.jpg", files[f"jpeg huffman {tag}"]))
        for coding in ("arith", "arith-progressive"):
            path = write(f"{coding}_{tag[0]}.jpg", files[f"jpeg {coding} {tag}"])
            got, secs = decode_seconds(path)
            assert np.array_equal(got, huff), (coding, tag)
            report(f"{coding.replace('-', ' ')} {tag} JPEG (quality {CODINGS_QUALITY}), bit-equal to its Huffman twin,",
                   path, secs, "the Huffman file's", huff_s)
    # (b) FillOrder 2 and BigTIFF
    sets = [(files[f"tiff {i}"], rasters[i], f"{('LZW 256² tiles', 'LZW 64-row strips', 'PackBits 64-row strips')[i]}")
            for i in range(3)] + [(files["tiff raw"], rasters[0], "uncompressed 64-row strips")]
    for variants, raster, layout in sets:
        plain, plain_s = decode_seconds(write("classic.tif", variants["classic"]))
        assert np.array_equal(plain[..., 0], raster)
        for variant in ("fill order 2", "bigtiff II", "bigtiff MM", "fill order 2 bigtiff MM"):
            got, secs = decode_seconds(write("variant.tif", variants[variant]))
            assert np.array_equal(got[..., 0], raster) and np.array_equal(got, plain), (variant, layout)
            report(f"{variant} {layout}", os.path.join(CODINGS_DIR, "variant.tif"), secs, "the classic file's", plain_s)
    # (b) fax
    plain, plain_s = decode_seconds(write("bilevel.tif", files["fax 1 0"]))
    assert np.array_equal(plain[..., 0] == 0, bits == 1)
    for key, what in (("fax 4 0", "Group 4"), ("fax 3 1", "Group 3 2D")):
        got, secs = decode_seconds(write("fax.tif", files[key]))
        assert np.array_equal(got, plain), what
        report(f"{what} (a thresholded micrograph, {int(bits.sum())} black pixels)",
               os.path.join(CODINGS_DIR, "fax.tif"), secs, "uncompressed 1-bit's", plain_s)
    shutil.rmtree(CODINGS_DIR, ignore_errors=True)

    # (c) --task inference on phase 12's rasters in the new codings
    home, folder = cli_home(model, [], name="codings")
    for i, (what, variant, _, _, _) in enumerate(CODINGS_CLI):
        with open(os.path.join(folder, f"micrograph_{i}.tif"), "wb") as f:
            f.write(files[f"tiff {i}"][variant])
        assert np.array_equal(read_image(os.path.join(folder, f"micrograph_{i}.tif"))[..., 0], rasters[i]), what
    argv = ["--task", "inference", "--dataset_name", "smoke", "--visualize", "--id", "--draw-scalebar",
            "--no-download", "--no-upload", "--device", "cuda"]
    child, wall, proc = cli_subprocess(home, argv)
    res = child["result"]
    names = sorted(os.listdir(folder))
    names = [n for n in names if n.endswith(".tif")]
    assert res["processed"] == names and not res["failed"], res
    rle, meas = read_csv(res["rle_csv"])[1:], read_csv(res["measurements_csv"])[1:]
    preflight = [ln for ln in proc.stderr.splitlines() if "CUDA device:" in ln]
    assert preflight and torch.cuda.get_device_name(0) in preflight[0], preflight
    same = (rle, meas) == tuple(phase12[1])
    print(f"codings: --task inference on {', '.join(w for w, *_ in CODINGS_CLI)} ({wall:.1f} s, its preflight "
          f"{preflight[0].split(': ', 1)[-1]!r}): rle_rows={len(rle)} measurement_rows={len(meas)}, byte-equal to "
          f"phase 12's: {same}; roi_align_fwd launches={child['launches']} (phase 12: {phase12[0]}), multilevel "
          f"calls with RoIs {child['with_rois']}; card {card}", flush=True)
    assert same, "phase 18's rows differ from phase 12's"
    assert child["launches"] == phase12[0] == child["with_rois"], (child["launches"], phase12[0])
    return child["launches"]


def codings_only():
    """Phase 18 alone, after phase 12's CLI run whose rows and launches it
    is held to (phase 3's R50 weights rebuilt from their seed)."""
    import shutil

    from deepemia_tpu_torch.kernels import _build
    from deepemia_tpu_torch.models.mask_rcnn import build_model

    card = card_line()
    print(f"card: {card}", flush=True)
    _build.build(["roi_align_fwd"])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            images = [synthetic_micrograph(2048, seed) for seed in range(3)]
            model = build_model("R50", num_classes=2, use_bf16=True, device="cuda", seed=0)
            sane_geometry(model)
        t0 = time.perf_counter()
        phase12 = phase_cli(model, images)
        print(f"phases 12 (CLI run): {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        launches = phase_codings(model, images, phase12, card)
        print(f"phases 18: {time.perf_counter() - t0:.1f} s", flush=True)
        print(json.dumps({"roi_align_fwd": launches}), flush=True)
    finally:
        shutil.rmtree(PIPELINE_DIR, ignore_errors=True)


# phase 19: one 1024x768 labelled micrograph in each container read_image reads beside PNG, TIFF, JPEG and
# BMP (the first a lossy WebP whose bytes the fixtures hold: the card's host has no WebP encoder), trained on
# for CONTAINER_STEPS steps and evaluated through the CLI
CONTAINER_FIXTURES = os.path.join(ROOT, "tests", "data", "torch_container_fixtures.npz")
CONTAINERS_DIR = os.path.join(ROOT, "build", "chip_smoke_containers")
CONTAINER_KINDS = ("webp-lossy", "pgm", "ppm", "pam", "pfm", "ras", "hdr", "gif", "webp-lossless")
CONTAINER_SEED = 19
CONTAINER_STEPS = 4
# the image libraries phase 19 looks for on the host (printed; nothing loads them)
HOST_LIBRARIES = ("libwebp", "libopenjp2", "libavif", "libdav1d", "libaom")
GRAY_PALETTE = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)


JPEG2000_FIXTURES = os.path.join(ROOT, "tests", "data", "torch_jpeg2000_fixtures.npz")
JPEG2000_DIR = os.path.join(ROOT, "build", "chip_smoke_jpeg2000")
# phase 20's dataset: one labelled frame in each JPEG 2000 form (the last one cv2 refuses)
JPEG2000_FORMS = ("rev", "irr", "tiled", "gray16", "la", "signed")
JPEG2000_SEED = 20

AVIF_FIXTURES = os.path.join(ROOT, "tests", "data", "torch_avif_fixtures.npz")
AVIF_DIR = os.path.join(ROOT, "build", "chip_smoke_avif")
# phase 21's dataset: one labelled frame in each lossless AVIF form
AVIF_FORMS = ("bgr", "mono", "10bit", "12bit", "irot", "extents")
AVIF_SEED = 21

AVIF_LOSSY_FIXTURES = os.path.join(ROOT, "tests", "data", "torch_avif_lossy_fixtures.npz")
AVIF_CDEF_FIXTURES = os.path.join(ROOT, "tests", "data", "torch_avif_cdef_fixtures.npz")
AVIF_LOSSY_DIR = os.path.join(ROOT, "build", "chip_smoke_avif_lossy")
# phase 22's dataset: one labelled frame (seed 22) in each lossy or subsampled form -> how far each may lie from
# the drawing (the lossless one not at all; the BGR ones hold the drawing in G, 12 levels up); bgr85 to
# gray12-90 deblocked, the last three deblocked and filtered with CDEF (their files in AVIF_CDEF_FIXTURES)
AVIF_LOSSY_FORMS = {"bgr95": 14, "gray95": 12, "bgr10-99": 14, "bgr12-99": 14, "writer420": 0, "bgr85": 22,
                    "bgr10-90": 8, "gray12-90": 8, "bgr-default": 104, "bgr10-75": 32, "gray12-default": 56}
AVIF_RESTORATION_FIXTURES = os.path.join(ROOT, "tests", "data", "torch_avif_restoration_fixtures.npz")
# phase 22's loop restoration frames (``smoke-<form>`` in AVIF_RESTORATION_FIXTURES: the labelled frame with
# ``avif_textured``'s texture, as cv2 writes it) -> how far each may lie from the textured drawing; the first four
# join the dataset, the last (CDEF, then restoration) is read in (b)
AVIF_RESTORATION_FORMS = {"lr-bgr8": 14, "lr-bgr10": 10, "lr-gray8": 14, "lr-gray10": 14, "lr-cdef-gray8": 12}
AVIF_PALETTE_FIXTURES = os.path.join(ROOT, "tests", "data", "torch_avif_palette_fixtures.npz")
AVIF_INTRABC_FIXTURES = os.path.join(ROOT, "tests", "data", "torch_avif_intrabc_fixtures.npz")
# phase 22's screen content frames (``smoke-<form>`` in AVIF_INTRABC_FIXTURES and AVIF_PALETTE_FIXTURES: the
# labelled frame as cv2 writes it at speed 4, with intra block copy and palettes, no in-loop filter; at speed 8, with
# palettes, deblocked, CDEF) -> how far each may lie from the drawing; both join the dataset for training
AVIF_PALETTE_FORMS = {"intrabc-bgr8": 8, "palette-bgr8": 96}
AVIF_DELTA_LF_FIXTURES = os.path.join(ROOT, "tests", "data", "torch_avif_delta_lf_fixtures.npz")
AVIF_SEGMENTATION_FIXTURES = os.path.join(ROOT, "tests", "data", "torch_avif_segmentation_fixtures.npz")
# phase 22's segmented frame (``smoke-writer-seg`` in AVIF_SEGMENTATION_FIXTURES: the writer's lossless 4:2:0 frame of
# the flattened drawing, eight segments, all lossless) -> its distance from the drawing; the dataset's last frame,
# sem_17, for training (of the eighteen the split holds out sem_00, sem_01, sem_05 and sem_08)
AVIF_SEGMENTATION_FORMS = {"writer-seg": 0}
# the committed frames cv2 reads and the port refuses by name: (fixture file, entry, the words of the refusal, what it
# is): the AV1 writer's frame with film grain
AVIF_NAMED = {"film-grain": (AVIF_CDEF_FIXTURES, "refused-film-grain-420-8", "AV1 film grain",
                             "the writer's frame with film grain")}
AVIF_LOSSY_SEED = 22


def avif_flatten(gray: np.ndarray) -> np.ndarray:
    """A ``draw_labelled`` frame with its background flattened to 80 (the
    instances, drawn at 160-230, kept): lossless AVIF of the noisy
    background would hold ~0.55 MB a frame."""
    return np.where(gray >= 150, gray, 80).astype(np.uint8)


def avif_textured(flat: np.ndarray, strength: int, seed: int = AVIF_LOSSY_SEED) -> np.ndarray:
    """``flat`` (an ``avif_flatten`` frame) with a texture added: uniform
    noise blurred by nine passes of the binomial [1, 4, 6, 4, 1] / 16 each
    way (integer arithmetic, edges held), its deviation from 128 times
    ``strength`` / 8. On such content libaom's encoder at speed 4 applies
    loop restoration (on the flat frame it takes screen content tools)."""
    t = np.random.default_rng(seed).integers(0, 256, flat.shape).astype(np.int64)
    h, w = t.shape
    for _ in range(9):
        p = np.pad(t, ((2, 2), (0, 0)), mode="edge")
        t = (p[:h] + 4 * p[1 : h + 1] + 6 * p[2 : h + 2] + 4 * p[3 : h + 3] + p[4 : h + 4] + 8) >> 4
    for _ in range(9):
        p = np.pad(t, ((0, 0), (2, 2)), mode="edge")
        t = (p[:, :w] + 4 * p[:, 1 : w + 1] + 6 * p[:, 2 : w + 2] + 4 * p[:, 3 : w + 3] + p[:, 4 : w + 4] + 8) >> 4
    return np.clip(flat.astype(np.int64) + ((t - 128) * strength >> 3), 0, 255).astype(np.uint8)


def container_file(kind: str, gray: np.ndarray):
    """A gray raster in one of phase 19's containers, written by the numpy
    writers of ``tools/make_torch_container_fixtures.py`` -> (extension,
    bytes): binary PGM, PPM, PAM (GRAYSCALE), PFM (the gray levels as
    floats, scale -1), 8-bit Sun raster, Radiance HDR (RLE scanlines of
    level / 255), GIF (a gray palette, code size 8) or lossless WebP
    (literal pixels, the subtract-green transform)."""
    h, w = gray.shape
    rgb = np.repeat(gray[..., None], 3, axis=2)
    if kind == "pgm":
        return ".pgm", containers.pnm(5, gray)
    if kind == "ppm":
        return ".ppm", containers.pnm(6, rgb)
    if kind == "pam":
        return ".pam", containers.pam(gray[..., None], 255, "GRAYSCALE")
    if kind == "pfm":
        return ".pfm", containers.pfm(rgb.astype(np.float32), -1.0)
    if kind == "ras":
        return ".ras", containers.sun(w, h, 8, gray)
    if kind == "hdr":
        return ".hdr", containers.hdr(containers.rgbe_of(rgb.astype(np.float32) / 255))
    if kind == "gif":
        return ".gif", containers.gif([dict(indices=gray, min_size=8)], (w, h), GRAY_PALETTE)
    assert kind == "webp-lossless", kind
    return ".webp", containers.vp8l(rgb)


def host_libraries() -> dict:
    """{library: the sonames ``ldconfig -p`` lists for it} over
    HOST_LIBRARIES."""
    import subprocess

    try:
        listing = subprocess.run(["ldconfig", "-p"], capture_output=True, text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        listing = ""
    names = [ln.split()[0] for ln in listing.splitlines() if ln.strip() and "=>" in ln]
    return {lib: sorted({n for n in names if n.startswith((lib + ".", lib + "-"))}) for lib in HOST_LIBRARIES}


def container_dataset(root: str, twin: str, hw=DATASET_HW, seed: int = CONTAINER_SEED) -> list:
    """Phase 19's dataset: one labelled micrograph (``draw_labelled``) per
    CONTAINER_KINDS in ``root``, the first the fixtures' lossy WebP of the
    same drawing, and in ``twin`` the same labels beside uncompressed RGB
    TIFFs of the arrays ``read_image`` decodes from those files -> the
    file names."""
    import hashlib

    from deepemia_tpu_torch.ops.image import read_image

    fixtures = np.load(CONTAINER_FIXTURES)
    rng = np.random.default_rng(seed)
    for d in (root, twin):
        os.makedirs(d, exist_ok=True)
    names = []
    for i, kind in enumerate(CONTAINER_KINDS):
        gray, instances = draw_labelled(rng, hw)
        if kind == "webp-lossy":
            ext, data = ".webp", fixtures["dataset-webp-lossy/file"].tobytes()
        else:
            ext, data = container_file(kind, gray)
        name = f"sem_{i:02d}{ext}"
        with open(os.path.join(root, name), "wb") as f:
            f.write(data)
        img = read_image(os.path.join(root, name))
        if kind == "webp-lossy":  # the arrays cv2 decoded from these bytes
            assert hashlib.sha256(img.tobytes()).hexdigest() == fixtures["dataset-webp-lossy/sha256"].tobytes().decode()
        elif kind != "hdr":  # RGBE keeps 8 bits of mantissa: 1/255 steps come back within one level
            assert np.array_equal(img[..., 0], gray) and np.array_equal(img[..., 2], gray), kind
        else:
            assert np.abs(img.astype(np.int16) - gray[..., None]).max() <= 1
        with open(os.path.join(twin, f"sem_{i:02d}.tif"), "wb") as f:
            f.write(codings.tiff_of(np.ascontiguousarray(img[..., ::-1])))
        for d, n in ((root, name), (twin, f"sem_{i:02d}.tif")):
            with open(os.path.join(d, f"sem_{i:02d}.json"), "w") as f:
                json.dump({"metadata": {"name": n, "height": hw[0], "width": hw[1]}, "instances": instances}, f)
        names.append(name)
    return names


def cli_on_dataset(tag, home, root, twin, files, card, skipped=(), device="cuda", config_hook=None,
                   steps=CONTAINER_STEPS):
    """Phases 19 (c) and 20 (c): the dataset of ``files`` in ``root``
    (``skipped``: those every reader refuses) registered as ``sem`` and its
    TIFF twins in ``twin`` as ``twin`` in ``home``, then through the port's
    CLI: ``--task prepare``, the first loader batch (4 images) bit-equal to
    the twins', K1 and K2 against their plain versions on one step of it,
    ``train --rcnn 50 --max-iter <steps>`` (finite losses, 2 K1 + 2 K2
    launches a step) and ``evaluate --rcnn 50`` (the JAX evaluator's metric
    names, 2 K1 launches a test image read, K1 against its plain version on
    its calls) -> (K1 launches, K2 launches, K1 errors, K2 errors)."""
    import yaml

    from deepemia_tpu_torch.config.config import default_config

    cfg = default_config(home)
    if config_hook:
        config_hook(cfg)
    os.makedirs(os.path.join(home, "config"))
    with open(os.path.join(home, "config", "config.yaml"), "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    with open(cfg["paths"]["category_json"], "w") as f:
        json.dump({"sem": [root, root, ["particle", "pore"]], "twin": [twin, twin, ["particle", "pore"]]}, f)
    flags = ["--dataset_name", "sem", "--no-download", "--no-upload", "--device", device, "--verbosity", "warning"]
    split_dir = cfg["paths"]["split_dir"]
    assert run_cli(home, "--task", "prepare", *flags) == 0
    with open(os.path.join(split_dir, "sem_split.json")) as f:
        split = json.load(f)
    n_test = math.ceil(0.2 * len(files))
    assert len(split["test"]) == n_test, split
    batch = loader_batch(cfg, split["train"], 4)
    twin_batch = loader_batch(cfg, split["train"], 4, dataset="twin")
    assert set(batch) == set(twin_batch) and all(np.array_equal(batch[k], twin_batch[k]) for k in batch)
    print(f"{tag}: prepare: split {len(split['train'])}/{n_test}; the first loader batch (4 images) equals "
          "the TIFF twins' key for key", flush=True)
    k1_errs, k2_errs = [], []
    if device == "cuda":
        k1_errs, k2_errs = hold_train_capture(capture_train_step(batch), f"{tag} 4-image loader batch")

    with TrainRun(device) as run, CountedRoIAlign() as roi:
        t0 = time.perf_counter()
        rc = run_cli(home, "--task", "train", "--rcnn", "50", "--max-iter", str(steps), *flags)
        wall = time.perf_counter() - t0
    assert rc == 0 and len(run.steps) == steps, (rc, len(run.steps))
    for st in run.steps:
        assert all(math.isfinite(st[k]) for k in ("rpn_cls", "rpn_loc", "cls", "box", "mask", "total")), st
        if device == "cuda":
            assert st["k1"] == 2 and st["k2"] == 2, st
    k1, k2 = roi.launches, sum(st["k2"] for st in run.steps)
    print(f"{tag}: train: {steps} steps from {len(split['train'])} records: {step_stats(run, steps)}; the task "
          f"took {wall:.1f} s; roi_align_fwd launches={roi.launches} roi_align_bwd launches={k2}; losses at the last "
          "step " + json.dumps({k: round(run.steps[-1][k], 5) for k in ("rpn_cls", "rpn_loc", "cls", "box", "mask",
                                                                           "total")}), flush=True)
    print(f"{tag}: train: loader waits " + json.dumps([round(x, 4) for x in run.waits[:steps]]), flush=True)

    with CountedRoIAlign(capture=True) as roi:
        t0 = time.perf_counter()
        assert run_cli(home, "--task", "evaluate", "--rcnn", "50", *flags) == 0
        wall = time.perf_counter() - t0
    with open(os.path.join(cfg["paths"]["output_dir"], "sem", "eval_r50", "metrics.csv")) as f:
        metrics = {k: float(v) for k, v in (ln.split(",") for ln in f.read().splitlines()[1:])}
    want = {f"{t}/{m}" for t in ("bbox", "segm") for m in ("AP", "AP50", "AP75", "APs", "APm", "APl", "AR1", "AR10",
                                                          "AR100", "ARs", "ARm", "ARl", "AP-class0", "AP-class1")}
    n_read = sum(f.split(".")[0] + ".json" in split["test"] for f in files if f not in skipped)
    assert set(metrics) == want | {"eval_seconds", "num_images"} and metrics["num_images"] == n_read, sorted(metrics)
    if device == "cuda":
        assert roi.launches == roi.with_rois == 2 * n_read, (roi.launches, roi.with_rois)
        errs, _ = hold_captured(roi.shapes, f"{tag} evaluate")
        k1_errs += errs
    k1 += roi.launches
    tested = [f + (" (refused, skipped)" if f in skipped else "") for f in files
              if f.split(".")[0] + ".json" in split["test"]]
    print(f"{tag}: evaluate: {n_test} test images ({', '.join(tested)}) in {wall:.1f} s, roi_align_fwd "
          f"launches={roi.launches} (2 per image read); bbox/AP={metrics['bbox/AP']:.4f} segm/AP={metrics['segm/AP']:.4f} "
          f"(random init, {steps} steps); card {card}", flush=True)
    return k1, k2, k1_errs, k2_errs


def phase_containers(image, card, device="cuda", config_hook=None, steps=CONTAINER_STEPS):
    """Phase 19: the containers ``read_image`` reads beside PNG, TIFF, JPEG
    and BMP. The host's image libraries (``ldconfig -p``, printed for
    information); (a) the committed fixtures
    (``tests/data/torch_container_fixtures.npz``: PNM, PAM, PFM, Sun
    raster, HDR, GIF, lossless, lossy, alpha and animated WebP and
    libwebp's encoder forms, each beside cv2's array or its SHA-256) decode
    bit for bit; (b) ``image``'s gray raster in each container, written by
    the numpy writers, and the fixtures' 2048² lossy WebP: the decode
    seconds (median of 3) beside an uncompressed TIFF of the same raster;
    (c) CONTAINER_KINDS' dataset through the port's CLI: ``--task
    prepare``, the first loader batch bit-equal to the TIFF twins', K1 and
    K2 against their plain versions on one step of a 4-image loader batch,
    ``train --rcnn 50 --max-iter <steps>`` (finite losses, 2 K1 + 2 K2
    launches a step) and ``evaluate --rcnn 50`` (the JAX evaluator's metric
    names, 2 K1 launches a test image, K1 against its plain version on its
    calls). -> (K1 launches, K2 launches, K1 errors, K2 errors)."""
    import hashlib
    import shutil

    from deepemia_tpu_torch.ops.image import read_image

    shutil.rmtree(CONTAINERS_DIR, ignore_errors=True)
    os.makedirs(CONTAINERS_DIR)
    print("containers: host image libraries (ldconfig -p; information only, nothing loads them) "
          + json.dumps(host_libraries()), flush=True)

    # (a) the fixtures
    fixtures = np.load(CONTAINER_FIXTURES)
    names = sorted({k.split("/")[0] for k in fixtures.files})
    for name in names:
        path = os.path.join(CONTAINERS_DIR, name + fixtures[f"{name}/ext"].tobytes().decode())
        with open(path, "wb") as f:
            f.write(fixtures[f"{name}/file"].tobytes())
        got = read_image(path)
        if f"{name}/bgr" in fixtures.files:
            assert np.array_equal(got, fixtures[f"{name}/bgr"]), name
        else:
            assert hashlib.sha256(got.tobytes()).hexdigest() == fixtures[f"{name}/sha256"].tobytes().decode(), name
        os.remove(path)
    print(f"containers: {len(names)} committed fixtures decode bit for bit to OpenCV's arrays ({', '.join(names)})",
          flush=True)

    # (b) decode seconds at 2048²
    gray = np.ascontiguousarray(image[..., 0])
    size = f"{gray.shape[1]}x{gray.shape[0]}"

    def timed(name, data):
        path = os.path.join(CONTAINERS_DIR, name)
        with open(path, "wb") as f:
            f.write(data)
        got, secs = decode_seconds(path)
        return got, secs, os.path.getsize(path)

    tiff_path = os.path.join(CONTAINERS_DIR, "plain.tif")
    write_tiff(tiff_path, gray)
    plain, plain_s = decode_seconds(tiff_path)
    for kind in CONTAINER_KINDS[1:]:
        t0 = time.perf_counter()
        ext, data = container_file(kind, gray)
        write_s = time.perf_counter() - t0
        got, secs, nbytes = timed(f"raster{ext}", data)
        diff = int(np.abs(got.astype(np.int16) - plain.astype(np.int16)).max())
        assert diff <= (1 if kind == "hdr" else 0), (kind, diff)
        print(f"containers: decode {kind} {size} ({nbytes} bytes, written by numpy in {write_s:.2f} s): "
              f"{secs:.4f} s beside uncompressed TIFF {plain_s:.4f} s (median of 3, host; max |diff| {diff})",
              flush=True)
    got, secs, nbytes = timed("lossy.webp", fixtures["webp-lossy-2048/file"].tobytes())
    assert hashlib.sha256(got.tobytes()).hexdigest() == fixtures["webp-lossy-2048/sha256"].tobytes().decode()
    write_tiff(tiff_path, got[..., 1])
    _, twin_s = decode_seconds(tiff_path)
    print(f"containers: decode webp-lossy {got.shape[1]}x{got.shape[0]} (the fixtures' libwebp file, quality 75, "
          f"{nbytes} bytes): {secs:.4f} s beside uncompressed TIFF {twin_s:.4f} s (median of 3, host)", flush=True)

    # (c) the dataset through the CLI
    home = os.path.join(CONTAINERS_DIR, "home")
    root, twin = os.path.join(home, "DATASET", "sem"), os.path.join(home, "DATASET", "twin")
    t0 = time.perf_counter()
    files = container_dataset(root, twin)
    print(f"containers: dataset of {len(files)} labelled {DATASET_HW[1]}x{DATASET_HW[0]} micrographs "
          f"({', '.join(files)}) and their TIFF twins written in {time.perf_counter() - t0:.1f} s", flush=True)
    k1, k2, k1_errs, k2_errs = cli_on_dataset("containers", home, root, twin, files, card, device=device,
                                              config_hook=config_hook, steps=steps)
    shutil.rmtree(CONTAINERS_DIR, ignore_errors=True)
    return k1, k2, k1_errs, k2_errs


def containers_only():
    """Phase 19 alone (phase 3's first 2048² micrograph rebuilt from its
    seed for the decode timings)."""
    import shutil

    from deepemia_tpu_torch.kernels import _build

    card = card_line()
    print(f"card: {card}", flush=True)
    _build.build(["roi_align_fwd", "roi_align_bwd"])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        k1, k2, k1_errs, k2_errs = phase_containers(synthetic_micrograph(2048, 0), card)
        print(f"phases 19: {time.perf_counter() - t0:.1f} s", flush=True)
        print(json.dumps({"roi_align_fwd": k1, "roi_align_bwd": k2, "max_abs_err_fwd": max(k1_errs),
                          "max_abs_err_bwd": max(k2_errs)}), flush=True)
    finally:
        shutil.rmtree(CONTAINERS_DIR, ignore_errors=True)


def jpeg2000_dataset(root: str, twin: str, hw=DATASET_HW, seed: int = JPEG2000_SEED):
    """Phase 20's dataset: one labelled micrograph (``draw_labelled``) per
    JPEG2000_FORMS in ``root``, each the fixtures' committed JP2 file of
    that drawing (its decode held to the SHA-256 of cv2's array), and in
    ``twin`` the same labels beside uncompressed RGB TIFFs of the arrays
    ``read_image`` decodes (for the frame cv2 refuses, a TIFF of a
    compression OpenCV refuses too) -> (the file names, those refused)."""
    import hashlib

    from deepemia_tpu_torch.ops.image import RefusedImageError, read_image

    fixtures = np.load(JPEG2000_FIXTURES)
    rng = np.random.default_rng(seed)
    for d in (root, twin):
        os.makedirs(d, exist_ok=True)
    names, refused = [], []
    for i, form in enumerate(JPEG2000_FORMS):
        gray, instances = draw_labelled(rng, hw)
        name = f"sem_{i:02d}.jp2"
        path = os.path.join(root, name)
        with open(path, "wb") as f:
            f.write(fixtures[f"dataset-{form}/file"].tobytes())
        if f"dataset-{form}/none" in fixtures.files:
            try:
                read_image(path)
                raise AssertionError(f"{form}: OpenCV refuses this frame and read_image read it")
            except RefusedImageError:
                pass
            twin_bytes = codings.tiff_of(np.repeat(gray[..., None], 3, 2), extra={259: (codings.SHORT, [34925])})
            refused.append(name)
        else:
            img = read_image(path)
            assert hashlib.sha256(img.tobytes()).hexdigest() == fixtures[f"dataset-{form}/sha256"].tobytes().decode()
            # the drawing survives the rate cut (most of what is lost is the background's noise)
            assert np.corrcoef(img[..., 1].ravel().astype(np.float64), gray.ravel())[0, 1] > 0.8, form
            twin_bytes = codings.tiff_of(np.ascontiguousarray(img[..., ::-1]))
        with open(os.path.join(twin, f"sem_{i:02d}.tif"), "wb") as f:
            f.write(twin_bytes)
        for d, n in ((root, name), (twin, f"sem_{i:02d}.tif")):
            with open(os.path.join(d, f"sem_{i:02d}.json"), "w") as f:
                json.dump({"metadata": {"name": n, "height": hw[0], "width": hw[1]}, "instances": instances}, f)
        names.append(name)
    return names, refused


def phase_jpeg2000(card, device="cuda", config_hook=None, steps=CONTAINER_STEPS):
    """Phase 20: JPEG 2000 (``native/jpeg2000.cpp``, ``ops/jpeg2000.py``)
    and the TIFF forms of C11. The host's machine and image libraries
    (``ldconfig -p``, printed; nothing loads them); (a) the committed
    fixtures (``tests/data/torch_jpeg2000_fixtures.npz``: Pillow's, cv2's
    and the numpy writer's JP2 files and codestreams, cut and damaged
    copies, the C11 TIFFs) decode bit for bit to cv2's arrays, or raise
    where cv2 returned None; (b) the committed 2048² micrograph,
    reversible (5/3, its layers cut by rate) and irreversible (9/7): host
    decode seconds (median of 3) beside an uncompressed TIFF of the same
    pixels; (c) the JPEG2000_FORMS dataset through the CLI
    (``cli_on_dataset``; the refused frame skipped by every reader) -> (K1
    launches, K2 launches, K1 errors, K2 errors)."""
    import hashlib
    import platform
    import shutil

    from deepemia_tpu_torch.ops.image import UnsupportedImageError, read_image

    shutil.rmtree(JPEG2000_DIR, ignore_errors=True)
    os.makedirs(JPEG2000_DIR)
    print(f"jpeg2000: host {platform.machine()}; image libraries (ldconfig -p; information only, nothing loads "
          "them) " + json.dumps(host_libraries()), flush=True)

    # (a) the fixtures
    fixtures = np.load(JPEG2000_FIXTURES)
    names = sorted({k.split("/")[0] for k in fixtures.files} - {f"dataset-{f}" for f in JPEG2000_FORMS})
    kinds = {"array": 0, "sha256": 0, "refused": 0}
    for name in names:
        path = os.path.join(JPEG2000_DIR, "f" + fixtures[f"{name}/ext"].tobytes().decode())
        with open(path, "wb") as f:
            f.write(fixtures[f"{name}/file"].tobytes())
        if f"{name}/none" in fixtures.files:
            try:
                read_image(path)
                raise AssertionError(f"{name}: OpenCV refuses this file and read_image read it")
            except UnsupportedImageError:
                raise
            except ValueError:
                kinds["refused"] += 1
        elif f"{name}/bgr" in fixtures.files:
            assert np.array_equal(read_image(path), fixtures[f"{name}/bgr"]), name
            kinds["array"] += 1
        else:
            got = read_image(path)
            assert hashlib.sha256(got.tobytes()).hexdigest() == fixtures[f"{name}/sha256"].tobytes().decode(), name
            kinds["sha256"] += 1
        os.remove(path)
    print(f"jpeg2000: {len(names)} committed fixtures as OpenCV read them: {kinds['array']} bit for bit to its "
          f"arrays, {kinds['sha256']} to its SHA-256, {kinds['refused']} refused where it returned None", flush=True)

    # (b) decode seconds at 2048²
    tiff_path = os.path.join(JPEG2000_DIR, "plain.tif")
    for name in ("smoke-rev-2048", "smoke-irr-2048"):
        path = os.path.join(JPEG2000_DIR, name + ".jp2")
        with open(path, "wb") as f:
            f.write(fixtures[f"{name}/file"].tobytes())
        got, secs = decode_seconds(path)
        assert hashlib.sha256(got.tobytes()).hexdigest() == fixtures[f"{name}/sha256"].tobytes().decode(), name
        write_tiff(tiff_path, got[..., 1])
        _, plain_s = decode_seconds(tiff_path)
        print(f"jpeg2000: decode {name} {got.shape[1]}x{got.shape[0]} ({os.path.getsize(path)} bytes, Pillow's "
              f"OpenJPEG encoder): {secs:.4f} s beside uncompressed TIFF {plain_s:.4f} s (median of 3, host)",
              flush=True)

    # (c) the dataset through the CLI
    home = os.path.join(JPEG2000_DIR, "home")
    root, twin = os.path.join(home, "DATASET", "sem"), os.path.join(home, "DATASET", "twin")
    t0 = time.perf_counter()
    files, refused = jpeg2000_dataset(root, twin)
    print(f"jpeg2000: dataset of {len(files)} labelled {DATASET_HW[1]}x{DATASET_HW[0]} micrographs in the forms "
          f"{', '.join(JPEG2000_FORMS)} ({', '.join(files)}; refused by OpenCV and read_image: {', '.join(refused)}) "
          f"and their TIFF twins written in {time.perf_counter() - t0:.1f} s", flush=True)
    k1, k2, k1_errs, k2_errs = cli_on_dataset("jpeg2000", home, root, twin, files, card, skipped=refused,
                                              device=device, config_hook=config_hook, steps=steps)
    shutil.rmtree(JPEG2000_DIR, ignore_errors=True)
    return k1, k2, k1_errs, k2_errs


def jpeg2000_only():
    """Phase 20 alone."""
    import shutil

    from deepemia_tpu_torch.kernels import _build

    card = card_line()
    print(f"card: {card}", flush=True)
    _build.build(["roi_align_fwd", "roi_align_bwd"])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        k1, k2, k1_errs, k2_errs = phase_jpeg2000(card)
        print(f"phases 20: {time.perf_counter() - t0:.1f} s", flush=True)
        print(json.dumps({"roi_align_fwd": k1, "roi_align_bwd": k2, "max_abs_err_fwd": max(k1_errs),
                          "max_abs_err_bwd": max(k2_errs)}), flush=True)
    finally:
        shutil.rmtree(JPEG2000_DIR, ignore_errors=True)


def _avif_tool():
    """``tools/make_torch_avif_fixtures.py``, loaded by its path: the box
    writer and ``c12_copies``, the seeded fuzz of damaged and cut C11
    TIFFs whose cv2 outcomes the fixtures hold."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_torch_avif_fixtures", os.path.join(ROOT, "tools", "make_torch_avif_fixtures.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def avif_dataset(root: str, twin: str, hw=DATASET_HW, seed: int = AVIF_SEED):
    """Phase 21's dataset: one labelled micrograph (``draw_labelled``, its
    background flattened by ``avif_flatten``) per AVIF_FORMS in ``root``,
    each the fixtures' committed lossless AVIF of that drawing (its decode
    held to the SHA-256 of cv2's array, and to the drawing), and in
    ``twin`` the same labels beside uncompressed RGB TIFFs of the arrays
    ``read_image`` decodes -> the file names."""
    import hashlib

    from deepemia_tpu_torch.ops.image import read_image

    fixtures = np.load(AVIF_FIXTURES)
    rng = np.random.default_rng(seed)
    for d in (root, twin):
        os.makedirs(d, exist_ok=True)
    names = []
    for i, form in enumerate(AVIF_FORMS):
        gray, instances = draw_labelled(rng, hw)
        name = f"sem_{i:02d}.avif"
        path = os.path.join(root, name)
        with open(path, "wb") as f:
            f.write(fixtures[f"dataset-{form}/file"].tobytes())
        img = read_image(path)
        assert hashlib.sha256(img.tobytes()).hexdigest() == fixtures[f"dataset-{form}/sha256"].tobytes().decode()
        # lossless: the drawing comes back (the 10- and 12-bit forms within a level of it)
        assert np.abs(img[..., 1].astype(np.int16) - avif_flatten(gray)).max() <= (0 if "bit" not in form else 1), form
        with open(os.path.join(twin, f"sem_{i:02d}.tif"), "wb") as f:
            f.write(codings.tiff_of(np.ascontiguousarray(img[..., ::-1])))
        for d, n in ((root, name), (twin, f"sem_{i:02d}.tif")):
            with open(os.path.join(d, f"sem_{i:02d}.json"), "w") as f:
                json.dump({"metadata": {"name": n, "height": hw[0], "width": hw[1]}, "instances": instances}, f)
        names.append(name)
    return names


def phase_avif(card, device="cuda", config_hook=None, steps=CONTAINER_STEPS):
    """Phase 21: lossless AVIF (``native/av1.cpp``, ``ops/avif.py``) and C12.
    (a) the committed fixtures (``tests/data/torch_avif_fixtures.npz``:
    cv2's lossless files at odd sizes, 8 to 12 bits, with alpha; the box
    writer's container forms; cut and damaged copies; the forms refused by
    name) decode bit for bit to cv2's arrays, raise where cv2 returned
    None, or raise ``UnsupportedImageError`` naming the form; and the 800
    damaged or cut C11 TIFFs of C12 give cv2's outcome (the SHA-256 of its
    array, or a ``ValueError`` where it returned None); (b) the committed
    2048² gray micrograph: host decode seconds (median of 3) beside an
    uncompressed TIFF of the same pixels; (c) the AVIF_FORMS dataset
    through the CLI (``cli_on_dataset``) -> (K1 launches, K2 launches, K1
    errors, K2 errors). (d) A lossy 4:2:0 AVIF that applies CDEF (cv2's at
    quality 75) and cv2's speed-4 frame with loop restoration decode to
    cv2's arrays; the AV1 writer's frame with film grain raises
    ``UnsupportedImageError`` naming it from ``read_image``, outside the
    dataset, since the loader would raise on it."""
    import hashlib
    import shutil

    from deepemia_tpu_torch.ops.image import UnsupportedImageError, read_image

    shutil.rmtree(AVIF_DIR, ignore_errors=True)
    os.makedirs(AVIF_DIR)

    # (a) the fixtures, then C12
    fixtures = np.load(AVIF_FIXTURES)
    names = sorted({k.split("/")[0] for k in fixtures.files} - {"c12"} - {f"dataset-{f}" for f in AVIF_FORMS})
    kinds = {"array": 0, "sha256": 0, "refused": 0, "named": 0}
    path = os.path.join(AVIF_DIR, "f.avif")
    for name in names:
        with open(path, "wb") as f:
            f.write(fixtures[f"{name}/file"].tobytes())
        try:
            got = read_image(path)
        except UnsupportedImageError as e:  # a form the port refuses by name, with the words the fixture holds
            assert f"{name}/named" in fixtures.files and fixtures[f"{name}/named"].tobytes().decode() in str(e), name
            kinds["named"] += 1
            continue
        except ValueError:
            assert f"{name}/none" in fixtures.files, f"{name}: read_image refused a file OpenCV reads"
            kinds["refused"] += 1
            continue
        assert f"{name}/none" not in fixtures.files, f"{name}: OpenCV refuses this file and read_image read it"
        if f"{name}/bgr" in fixtures.files:
            assert np.array_equal(got, fixtures[f"{name}/bgr"]), name
            kinds["array"] += 1
        else:
            assert hashlib.sha256(got.tobytes()).hexdigest() == fixtures[f"{name}/sha256"].tobytes().decode(), name
            kinds["sha256"] += 1
    os.remove(path)
    print(f"avif: {len(names)} committed fixtures as OpenCV read them: {kinds['array']} bit for bit to its arrays, "
          f"{kinds['sha256']} to its SHA-256, {kinds['refused']} refused where it returned None, {kinds['named']} "
          f"named as forms the port does not decode", flush=True)
    c11 = np.load(JPEG2000_FIXTURES)
    hashes = fixtures["c12/sha256"]
    tif = os.path.join(AVIF_DIR, "f.tif")
    c12 = {"array": 0, "refused": 0}
    for i, (name, data) in enumerate(_avif_tool().c12_copies(c11)):
        with open(tif, "wb") as f:
            f.write(data)
        want = hashes[i].tobytes().decode() if hashes[i].any() else None
        try:
            got = hashlib.sha256(read_image(tif).tobytes()).hexdigest()
        except UnsupportedImageError:
            raise
        except ValueError:
            got = None
        assert got == want, (name, got, want)
        c12["array" if want else "refused"] += 1
    os.remove(tif)
    print(f"avif: C12, {sum(c12.values())} damaged or cut C11 TIFFs as OpenCV read them: {c12['array']} to the "
          f"SHA-256 of its array, {c12['refused']} refused where it returned None", flush=True)

    # (b) decode seconds at 2048²
    tiff_path = os.path.join(AVIF_DIR, "plain.tif")
    path = os.path.join(AVIF_DIR, "smoke-gray-2048.avif")
    with open(path, "wb") as f:
        f.write(fixtures["smoke-gray-2048/file"].tobytes())
    got, secs = decode_seconds(path)
    assert hashlib.sha256(got.tobytes()).hexdigest() == fixtures["smoke-gray-2048/sha256"].tobytes().decode()
    write_tiff(tiff_path, got[..., 1])
    _, plain_s = decode_seconds(tiff_path)
    print(f"avif: decode smoke-gray-2048 {got.shape[1]}x{got.shape[0]} ({os.path.getsize(path)} bytes, lossless, "
          f"cv2's libavif/libaom writer): {secs:.4f} s beside uncompressed TIFF {plain_s:.4f} s (median of 3, host; "
          f"{card})", flush=True)

    # (d) the lossy forms that apply CDEF and loop restoration, read; film grain, refused by name outside the dataset
    path = os.path.join(AVIF_DIR, "lossy.avif")
    with open(path, "wb") as f:
        f.write(fixtures["refused-lossy-420/file"].tobytes())
    assert np.array_equal(read_image(path), fixtures["refused-lossy-420/bgr"])
    print("avif: lossy 4:2:0 (cv2 at quality 75, deblocked and CDEF) decoded bit for bit to cv2's array", flush=True)
    cdef_fixtures = np.load(AVIF_CDEF_FIXTURES)
    path = os.path.join(AVIF_DIR, "restoration.avif")
    with open(path, "wb") as f:
        f.write(cdef_fixtures["refused-restoration-bgr8-128x128/file"].tobytes())
    got = read_image(path)
    assert hashlib.sha256(got.tobytes()).hexdigest() == \
        cdef_fixtures["refused-restoration-bgr8-128x128/sha256"].tobytes().decode()
    print("avif: cv2's frame at speed 4 (loop restoration) decoded to the SHA-256 of cv2's array", flush=True)
    refuse_named("avif", path, "film-grain")

    # (c) the dataset through the CLI
    home = os.path.join(AVIF_DIR, "home")
    root, twin = os.path.join(home, "DATASET", "sem"), os.path.join(home, "DATASET", "twin")
    t0 = time.perf_counter()
    files = avif_dataset(root, twin)
    print(f"avif: dataset of {len(files)} labelled {DATASET_HW[1]}x{DATASET_HW[0]} micrographs in the lossless "
          f"forms {', '.join(AVIF_FORMS)} ({', '.join(files)}) and their TIFF twins written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    k1, k2, k1_errs, k2_errs = cli_on_dataset("avif", home, root, twin, files, card, device=device,
                                              config_hook=config_hook, steps=steps)
    shutil.rmtree(AVIF_DIR, ignore_errors=True)
    return k1, k2, k1_errs, k2_errs


def refuse_named(tag: str, path: str, form: str) -> None:
    """An ``AVIF_NAMED`` frame raises ``UnsupportedImageError`` naming its
    tool (film grain in phases 21 (d) and 22 (b))."""
    from deepemia_tpu_torch.ops.image import UnsupportedImageError, read_image

    fixtures, name, words, what = AVIF_NAMED[form]
    with open(path, "wb") as f:
        f.write(np.load(fixtures)[f"{name}/file"].tobytes())
    try:
        read_image(path)
        raise AssertionError(f"read_image decoded {what}")
    except UnsupportedImageError as e:
        assert words in str(e), e
        print(f"{tag}: {what}: {str(e).split(': ', 1)[1]}", flush=True)


def read_committed_fixtures(tag: str, path: str, fixtures_path: str, what: str) -> None:
    """A committed fixture file's frames but the 2048² rasters and the one
    once refused by name (the loop restoration file's: cv2's frames at
    speeds 0-4, the AV1 writer's, phase 22's textured frames; the palette
    file's: cv2's palette frames at speeds 0-8, the writer's, phase 22's
    palette frame; the intra block copy file's: cv2's frames at speeds 0-7,
    the writer's, phase 22's frame; the delta loop filter level file's: the
    writer's frames, phase 22's timing pair; the segmentation file's: the
    writer's frames, phase 22's dataset frame and timing pair) decode to
    cv2's arrays or their SHA-256, and those cv2 reads nothing of (the
    writer's DV into its own undecoded block, its segment id past the last
    active segment) fail as a corrupt stream (phase 22 (b))."""
    import hashlib

    from deepemia_tpu_torch.ops.image import UnsupportedImageError, read_image

    fixtures = np.load(fixtures_path)
    names = sorted(n for n in {k.split("/")[0] for k in fixtures.files}
                   if not n.startswith(("smoke-2048", "refused-")))
    kinds = {"array": 0, "sha256": 0, "none": 0}
    for name in names:
        with open(path, "wb") as f:
            f.write(fixtures[f"{name}/file"].tobytes())
        if f"{name}/none" in fixtures.files:
            try:
                read_image(path)
                raise AssertionError(f"read_image decoded {name}, which cv2 fails on")
            except UnsupportedImageError:
                raise
            except ValueError:
                kinds["none"] += 1
            continue
        got = read_image(path)
        if f"{name}/bgr" in fixtures.files:
            assert np.array_equal(got, fixtures[f"{name}/bgr"]), name
            kinds["array"] += 1
        else:
            assert hashlib.sha256(got.tobytes()).hexdigest() == fixtures[f"{name}/sha256"].tobytes().decode(), name
            kinds["sha256"] += 1
    os.remove(path)
    print(f"{tag}: {len(names)} committed {what} fixtures as OpenCV read them: {kinds['array']} bit for "
          f"bit to its arrays, {kinds['sha256']} to its SHA-256"
          + (f", {kinds['none']} failing where it fails" if kinds["none"] else ""), flush=True)


def avif_only():
    """Phase 21 alone."""
    import shutil

    from deepemia_tpu_torch.kernels import _build

    card = card_line()
    print(f"card: {card}", flush=True)
    _build.build(["roi_align_fwd", "roi_align_bwd"])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        k1, k2, k1_errs, k2_errs = phase_avif(card)
        print(f"phases 21: {time.perf_counter() - t0:.1f} s", flush=True)
        print(json.dumps({"roi_align_fwd": k1, "roi_align_bwd": k2, "max_abs_err_fwd": max(k1_errs),
                          "max_abs_err_bwd": max(k2_errs)}), flush=True)
    finally:
        shutil.rmtree(AVIF_DIR, ignore_errors=True)


def avif_lossy_forms() -> dict:
    """Phase 22's dataset forms -> their tolerances: AVIF_LOSSY_FORMS, the
    loop restoration forms but the last of AVIF_RESTORATION_FORMS,
    AVIF_PALETTE_FORMS, then AVIF_SEGMENTATION_FORMS."""
    return {**AVIF_LOSSY_FORMS, **dict(list(AVIF_RESTORATION_FORMS.items())[:-1]), **AVIF_PALETTE_FORMS,
            **AVIF_SEGMENTATION_FORMS}


def avif_lossy_fixtures() -> dict:
    """Phase 22's fixture files, merged: lossy, CDEF, loop restoration, palette and, of intra block copy and
    segmentation, phase 22's frames."""
    intrabc, seg = np.load(AVIF_INTRABC_FIXTURES), np.load(AVIF_SEGMENTATION_FIXTURES)
    return {**np.load(AVIF_LOSSY_FIXTURES), **np.load(AVIF_CDEF_FIXTURES), **np.load(AVIF_RESTORATION_FIXTURES),
            **np.load(AVIF_PALETTE_FIXTURES), **{k: intrabc[k] for k in intrabc.files if k.startswith("smoke-")},
            **{k: seg[k] for k in seg.files if k.startswith("smoke-")}}


def avif_lossy_dataset(root: str, twin: str, hw=DATASET_HW, seed: int = AVIF_LOSSY_SEED):
    """Phase 22's dataset: the labelled micrograph ``draw_labelled`` makes
    from ``seed`` in each ``avif_lossy_forms`` form in ``root``, each the
    fixtures' committed file (its decode held to the SHA-256 of cv2's array,
    and to the drawing with its background flattened, the restoration
    forms' with ``avif_textured``'s texture added), and in ``twin`` the
    same labels beside uncompressed RGB TIFFs of the arrays ``read_image``
    decodes -> the file names."""
    import hashlib

    from deepemia_tpu_torch.ops.image import read_image

    fixtures = avif_lossy_fixtures()
    gray, instances = draw_labelled(np.random.default_rng(seed), hw)
    flat = avif_flatten(gray)
    for d in (root, twin):
        os.makedirs(d, exist_ok=True)
    names = []
    for i, (form, tol) in enumerate(avif_lossy_forms().items()):
        name = f"sem_{i:02d}.avif"
        path = os.path.join(root, name)
        with open(path, "wb") as f:
            f.write(fixtures[f"smoke-{form}/file"].tobytes())
        img = read_image(path)
        assert hashlib.sha256(img.tobytes()).hexdigest() == fixtures[f"smoke-{form}/sha256"].tobytes().decode(), form
        drawn = flat if f"smoke-{form}/strength" not in fixtures else \
            avif_textured(flat, int(fixtures[f"smoke-{form}/strength"][0]))
        err = np.abs(img[..., 1].astype(np.int16) - drawn - (12 if "bgr" in form else 0))
        assert err.max() <= tol, (form, int(err.max()))
        with open(os.path.join(twin, f"sem_{i:02d}.tif"), "wb") as f:
            f.write(codings.tiff_of(np.ascontiguousarray(img[..., ::-1])))
        for d, n in ((root, name), (twin, f"sem_{i:02d}.tif")):
            with open(os.path.join(d, f"sem_{i:02d}.json"), "w") as f:
                json.dump({"metadata": {"name": n, "height": hw[0], "width": hw[1]}, "instances": instances}, f)
        names.append(name)
    return names


def phase_avif_lossy(card, device="cuda", config_hook=None, steps=CONTAINER_STEPS):
    """Phase 22: lossy and subsampled AVIF. (a) the ``avif_lossy_forms``
    dataset written (``avif_lossy_dataset``: each frame to the SHA-256 of
    cv2's array and near the drawing; three of them deblocked, three more
    deblocked and filtered with CDEF, four with loop restoration, one with
    palettes, one with intra block copy, one with segmentation, the
    drawing exactly); (b) cv2's quality-75 frame, which deblocks and
    applies CDEF, and the textured gray frame with CDEF then loop
    restoration, to the SHA-256 of cv2's arrays, the committed
    restoration, palette, intra block copy, delta loop filter level and
    segmentation fixtures to cv2's arrays (``read_committed_fixtures``),
    and the AV1 writer's frame with film grain raises
    ``UnsupportedImageError`` naming it; (c) the committed
    2048² BGR micrograph at quality 95, at 85 (deblocked) and at cv2's
    default quality (deblocked, CDEF), blurred noise at speed 4
    (self-guided restoration in every plane), and the flattened labelled
    frame tiled to 2048² at speed 4 (intra block copy), at speed 8
    (palettes) and at cv2's default speed:
    host decode seconds (median of 3) beside an uncompressed TIFF of the
    same pixels, each as a multiple of quality 95's, the AV1 writer's 1024²
    frame with delta loop filter levels beside its twin with every delta 0,
    and its 1024² frame with ALT_Q and ALT_LF segments beside its twin from
    the same seed with segmentation off (median of 3, each as a ratio),
    with the card's name and power limit; (d) the dataset through the CLI (``cli_on_dataset``)
    -> (K1 launches, K2 launches, K1 errors, K2 errors)."""
    import hashlib
    import shutil

    from deepemia_tpu_torch.ops.image import read_image

    shutil.rmtree(AVIF_LOSSY_DIR, ignore_errors=True)
    os.makedirs(AVIF_LOSSY_DIR)
    fixtures = avif_lossy_fixtures()
    home = os.path.join(AVIF_LOSSY_DIR, "home")
    root, twin = os.path.join(home, "DATASET", "sem"), os.path.join(home, "DATASET", "twin")
    t0 = time.perf_counter()
    files = avif_lossy_dataset(root, twin)
    print(f"avif lossy: {len(files)} labelled {DATASET_HW[1]}x{DATASET_HW[0]} micrographs in the forms "
          f"{', '.join(avif_lossy_forms())} ({', '.join(files)}) decoded to the SHA-256 of cv2's arrays, and their TIFF "
          f"twins written, in {time.perf_counter() - t0:.1f} s", flush=True)

    # (b) frames that deblock and apply CDEF, and CDEF then loop restoration, read; the restoration, palette, intra
    # block copy, delta LF and segmentation fixtures, read; film grain, refused by name
    for name, what in (("smoke-q75", "quality 75, deblocked and CDEF"),
                       ("smoke-lr-cdef-gray8", "textured, 8-bit gray, CDEF then self-guided restoration")):
        path = os.path.join(AVIF_LOSSY_DIR, f"{name}.avif")
        with open(path, "wb") as f:
            f.write(fixtures[f"{name}/file"].tobytes())
        got = read_image(path)
        assert hashlib.sha256(got.tobytes()).hexdigest() == fixtures[f"{name}/sha256"].tobytes().decode(), name
        print(f"avif lossy: the same frame ({what}) decoded to the SHA-256 of cv2's array", flush=True)
    read_committed_fixtures("avif lossy", os.path.join(AVIF_LOSSY_DIR, "lr.avif"), AVIF_RESTORATION_FIXTURES,
                            "loop restoration")
    read_committed_fixtures("avif lossy", os.path.join(AVIF_LOSSY_DIR, "palette.avif"), AVIF_PALETTE_FIXTURES,
                            "palette")
    read_committed_fixtures("avif lossy", os.path.join(AVIF_LOSSY_DIR, "intrabc.avif"), AVIF_INTRABC_FIXTURES,
                            "intra block copy")
    read_committed_fixtures("avif lossy", os.path.join(AVIF_LOSSY_DIR, "delta_lf.avif"), AVIF_DELTA_LF_FIXTURES,
                            "delta loop filter level")
    read_committed_fixtures("avif lossy", os.path.join(AVIF_LOSSY_DIR, "segmentation.avif"),
                            AVIF_SEGMENTATION_FIXTURES, "segmentation")
    for form in AVIF_NAMED:
        refuse_named("avif lossy", os.path.join(AVIF_LOSSY_DIR, f"{form}.avif"), form)

    # (c) decode seconds at 2048²: quality 95, 85 (deblocked), cv2's default (deblocked, CDEF) and speed 4 (restoration)
    q95 = None
    for name, what in (("smoke-2048-q95", "micrograph at quality 95, no in-loop filter"),
                       ("smoke-2048-q85", "micrograph at quality 85, deblocked"),
                       ("smoke-2048-default", "micrograph at the default quality, deblocked and CDEF"),
                       ("smoke-2048-speed4", "blurred noise at speed 4, quality 75, self-guided restoration in "
                        "every plane"),
                       ("smoke-2048-intrabc", "the flattened labelled frame tiled, at speed 4: screen content "
                        "tools, intra block copy and palettes, no in-loop filter"),
                       ("smoke-2048-palette", "the same tiled frame at speed 8: screen content tools, palettes, "
                        "deblocked and CDEF"),
                       ("smoke-2048-speed9", "the same tiled frame at cv2's default speed: no screen content tools, "
                        "deblocked and CDEF")):
        path = os.path.join(AVIF_LOSSY_DIR, f"{name}.avif")
        with open(path, "wb") as f:
            f.write(fixtures[f"{name}/file"].tobytes())
        got, secs = decode_seconds(path)
        assert hashlib.sha256(got.tobytes()).hexdigest() == fixtures[f"{name}/sha256"].tobytes().decode(), name
        tiff_path = os.path.join(AVIF_LOSSY_DIR, "plain.tif")
        with open(tiff_path, "wb") as f:
            f.write(codings.tiff_of(np.ascontiguousarray(got[..., ::-1])))
        _, plain_s = decode_seconds(tiff_path)
        q95 = q95 or secs
        print(f"avif lossy: decode {name} {got.shape[1]}x{got.shape[0]} ({os.path.getsize(path)} bytes, BGR 4:2:0, "
              f"{what}, cv2's libavif/libaom writer): {secs:.4f} s ({secs / q95:.2f}x quality 95's) "
              f"beside uncompressed RGB TIFF {plain_s:.4f} s (median of 3, host; {card})", flush=True)
    secs = {}
    for fixtures_path, pair in ((AVIF_DELTA_LF_FIXTURES, ("timing-1024-delta-lf", "timing-1024-zero-deltas")),
                                (AVIF_SEGMENTATION_FIXTURES, ("timing-1024-segmentation", "timing-1024-no-segmentation"))):
        timed = np.load(fixtures_path)
        for name in pair:
            path = os.path.join(AVIF_LOSSY_DIR, f"{name}.avif")
            with open(path, "wb") as f:
                f.write(timed[f"{name}/file"].tobytes())
            got, secs[name] = decode_seconds(path)
            assert hashlib.sha256(got.tobytes()).hexdigest() == timed[f"{name}/sha256"].tobytes().decode(), name
    ratio = secs["timing-1024-delta-lf"] / secs["timing-1024-zero-deltas"]
    print(f"avif lossy: decode timing-1024-delta-lf 1024x1024 (the AV1 writer's 4:2:0 frame, delta loop filter levels "
          f"per plane and direction, deblocked at a level per block): {secs['timing-1024-delta-lf']:.4f} s beside its "
          f"twin with every delta 0 {secs['timing-1024-zero-deltas']:.4f} s: {ratio:.2f}x (median of 3, host; {card})",
          flush=True)
    ratio = secs["timing-1024-segmentation"] / secs["timing-1024-no-segmentation"]
    print(f"avif lossy: decode timing-1024-segmentation 1024x1024 (the AV1 writer's 4:2:0 frame, four segments with "
          f"ALT_Q and ALT_LF, a quantizer and deblocking levels per segment): {secs['timing-1024-segmentation']:.4f} s "
          f"beside its twin from the same seed with segmentation off {secs['timing-1024-no-segmentation']:.4f} s: "
          f"{ratio:.2f}x (median of 3, host; {card})", flush=True)

    # (d) the dataset through the CLI
    k1, k2, k1_errs, k2_errs = cli_on_dataset("avif lossy", home, root, twin, files, card, device=device,
                                              config_hook=config_hook, steps=steps)
    shutil.rmtree(AVIF_LOSSY_DIR, ignore_errors=True)
    return k1, k2, k1_errs, k2_errs


def avif_lossy_only():
    """Phase 22 alone."""
    import shutil

    from deepemia_tpu_torch.kernels import _build

    card = card_line()
    print(f"card: {card}", flush=True)
    _build.build(["roi_align_fwd", "roi_align_bwd"])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        k1, k2, k1_errs, k2_errs = phase_avif_lossy(card)
        print(f"phases 22: {time.perf_counter() - t0:.1f} s", flush=True)
        print(json.dumps({"roi_align_fwd": k1, "roi_align_bwd": k2, "max_abs_err_fwd": max(k1_errs),
                          "max_abs_err_bwd": max(k2_errs)}), flush=True)
    finally:
        shutil.rmtree(AVIF_LOSSY_DIR, ignore_errors=True)


def parallel_only():
    """Phases 1, 11, 16 and 17 alone (phase 3's R50 weights rebuilt from
    their seed; phase 11 makes the rows phase 16 (b) is held to, phase 12's
    CLI run those phase 17 (a) is held to)."""
    import shutil

    from deepemia_tpu_torch.kernels import _build
    from deepemia_tpu_torch.models.mask_rcnn import build_model

    card = card_line()
    print(f"card: {card}", flush=True)
    _build.build(["roi_align_fwd", "roi_align_bwd", "int8_conv", "int8_quant"])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    try:
        with torch.inference_mode():
            images = [synthetic_micrograph(2048, seed) for seed in range(3)]
            model = build_model("R50", num_classes=2, use_bf16=True, device="cuda", seed=0)
            sane_geometry(model)
            _, _, ensemble_rows = phase_ensemble(model, images)
        phase12 = phase_cli(model, images)
        t1 = time.perf_counter()
        with torch.inference_mode():
            k1a, k4, k5 = phase_sharded_serving(model, images[0], card)
        k1b = phase_chips_cli(model, images, ensemble_rows, card)
        k1c, k2, one_step = phase_ranks(card)
        t2 = time.perf_counter()
        k1d, k4d, k5d = phase_rank_inference(model, images, phase12, card)
        k1e, k2e = phase_tp_training(one_step, card)
        print(json.dumps({"roi_align_fwd": k1a + k1b + k1c + k1d + k1e, "roi_align_bwd": k2 + k2e,
                          "int8_conv": k4 + k4d, "int8_quant": k5 + k5d}), flush=True)
        print(f"phase 16: {t2 - t1:.1f} s, phase 17: {time.perf_counter() - t2:.1f} s (phases 11 and 12 before "
              f"them {t1 - t0:.1f} s)", flush=True)
    finally:
        shutil.rmtree(PIPELINE_DIR, ignore_errors=True)
        shutil.rmtree(RANKS_DIR, ignore_errors=True)


def entry_points_only():
    """Phase 15 alone, after phase 12's CLI run whose rows it holds the
    panel's to (phase 3's R50 weights rebuilt from their seed)."""
    import shutil

    from deepemia_tpu_torch.kernels import _build
    from deepemia_tpu_torch.models.mask_rcnn import build_model

    print(f"card: {card_line()}", flush=True)
    _build.build(["roi_align_fwd", "int8_conv", "int8_quant"])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            images = [synthetic_micrograph(2048, seed) for seed in range(3)]
            model = build_model("R50", num_classes=2, use_bf16=True, device="cuda", seed=0)
            sane_geometry(model)
        _, cli_rows = phase_cli(model, images)
        print(json.dumps(dict(zip(("roi_align_fwd", "int8_conv", "int8_quant"),
                                  phase_entry_points(model, images, cli_rows)))), flush=True)
    finally:
        shutil.rmtree(PIPELINE_DIR, ignore_errors=True)


def int8_only():
    """Phases 1 and 14 alone: the build, the JPEG fixtures, K4 and K5 at
    every trunk + FPN shape, the int8 trunk card vs CPU and the int8 CLI
    runs (phase 3's R50 weights rebuilt from their seed)."""
    import shutil

    from deepemia_tpu_torch.kernels import _build
    from deepemia_tpu_torch.models.mask_rcnn import build_model

    print(f"card: {card_line()}", flush=True)
    sources = ["roi_align_fwd", "int8_conv", "int8_quant"]
    _build.build(sources)
    for nm in sources:
        for line in _build.build_logs.get(nm, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {nm}:", line.strip(), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            images = [synthetic_micrograph(2048, seed) for seed in range(3)]
            phase_jpeg_fixtures()
            phase_int8_conv(images)
            phase_int8_trunk_reference()
            model = build_model("R50", num_classes=2, use_bf16=True, device="cuda", seed=0)
            sane_geometry(model)
        phase_int8_cli(model, images)
    finally:
        shutil.rmtree(PIPELINE_DIR, ignore_errors=True)
        shutil.rmtree(INT8_DIR, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--k3-times"]:  # before this checkout's package is imported
        print(f"card: {card_line()}", flush=True)
        k3_times(sys.argv[2])
        return 0
    from deepemia_tpu_torch.kernels import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    laps = [t_start]

    def lap(phases):
        laps.append(time.perf_counter())
        print(f"phases {phases}: {laps[-1] - laps[-2]:.1f} s", flush=True)

    parts = [t_start]

    def part(what):  # the seconds since the last lap or part, within a phase
        parts.append(time.perf_counter())
        print(f"part {what}: {parts[-1] - max(parts[-2], laps[-1]):.1f} s", flush=True)

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}", flush=True)

    sources = ["roi_align_fwd", "roi_align_bwd", "window_sum", "int8_conv", "int8_quant"]
    _, build_s = sync_time(lambda: _build.build(sources))
    print(f"build: {', '.join(nm + '.cu' for nm in sources)} in {build_s:.2f} s (in parallel)", flush=True)
    for nm in sources:
        for line in _build.build_logs.get(nm, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {nm}:", line.strip(), flush=True)

    with torch.inference_mode():
        tile_rows = phase_kernel_vs_plain()
        images = [synthetic_micrograph(2048, seed) for seed in range(3)]
        model, engine, launches = phase_slice(images)
        calls = capture_tile_batch(model, engine, images[0])
        captured = phase_captured(calls)
        phase_stage_times(model, engine, images[0])
        phase_small_reference()
    lap("build and 1-5")

    batches = synthetic_train_batches(4, seed=7)
    train_launches, _ = phase_train(batches)
    bwd_rows = phase_backward(capture_train_step(batches[0]))
    phase_backward_edges()
    phase_train_reference()
    phase_train_profile(batches[1])
    lap("6-8")

    import shutil

    writers = []  # host file writers started ahead of their phase (spawned pools), stopped in any case
    try:
        pipeline_launches, pipeline_errs = phase_pipeline(model, images)
        part("9, the pipeline")
        phase_pipeline_reference(model)
        part("9, the 256² references")
        lap(9)
        # phases 12 and 14's files, written while phases 11 and 12 run
        writers.append(host_pool(4))
        prefetch_cli_files(writers[-1], images)
        prefetch_cli_files(writers[-1], images[:1], jpeg=(0,))
        with torch.inference_mode():
            jpeg_encodes = start_jpeg_encodes(writers[-1])
            ensemble_launches, ensemble_errs, ensemble_rows = phase_ensemble(model, images)
        lap(11)
        cli_launches, cli_rows = phase_cli(model, images)
        phase12 = (cli_launches, cli_rows)
        part("12, the CLI")
        with torch.inference_mode():
            cli_launches += phase_device_measurements(model, images)
            part("12, the device measurements")
            cli_launches += phase_windowed_rle(model)
        lap(12)
        with torch.inference_mode():
            phase_jpeg_fixtures(encodes=jpeg_encodes)
            part("14, JPEG")
            int8_rows, int8_err, int8_sums, int8_times, quant_rows, quant_err, quant_sums, trunk_split = \
                phase_int8_conv(images)
            part("14, K4 and K5")
            phase_int8_trunk_reference()
        int8_launches, quant_launches = phase_int8_cli(model, images)
        lap(14)
        entry_k1, entry_k4, entry_k5 = phase_entry_points(model, images, cli_rows)
        lap(15)
        with torch.inference_mode():
            shard_k1, shard_k4, shard_k5 = phase_sharded_serving(model, images[0], card)
        shard_k1 += phase_chips_cli(model, images, ensemble_rows, card)
        lap("16 (a, b)")
        rank_k1, rank_k4, rank_k5 = phase_rank_inference(model, images, phase12, card)
        lap("17 (a)")
        codings_k1 = phase_codings(model, images, phase12, card)
        lap(18)
    finally:
        for pool in writers:
            pool.shutdown(cancel_futures=True)
        shutil.rmtree(PIPELINE_DIR, ignore_errors=True)
        shutil.rmtree(INT8_DIR, ignore_errors=True)
    try:
        dataset_k1, dataset_k2, dataset_k1_errs, dataset_k2_errs = phase_train_dataset()
    finally:
        shutil.rmtree(DATASET_DIR, ignore_errors=True)
    lap(13)
    try:
        containers_k1, containers_k2, containers_k1_errs, containers_k2_errs = phase_containers(images[0], card)
    finally:
        shutil.rmtree(CONTAINERS_DIR, ignore_errors=True)
    lap(19)
    try:
        j2k_k1, j2k_k2, j2k_k1_errs, j2k_k2_errs = phase_jpeg2000(card)
    finally:
        shutil.rmtree(JPEG2000_DIR, ignore_errors=True)
    lap(20)
    try:
        avif_k1, avif_k2, avif_k1_errs, avif_k2_errs = phase_avif(card)
    finally:
        shutil.rmtree(AVIF_DIR, ignore_errors=True)
    lap(21)
    try:
        lossy_k1, lossy_k2, lossy_k1_errs, lossy_k2_errs = phase_avif_lossy(card)
    finally:
        shutil.rmtree(AVIF_LOSSY_DIR, ignore_errors=True)
    lap(22)
    try:
        ranks_k1, ranks_k2, one_step = phase_ranks(card)
        lap("16 (c)")
        tp_k1, tp_k2 = phase_tp_training(one_step, card)
        lap("17 (b)")
    finally:
        shutil.rmtree(RANKS_DIR, ignore_errors=True)
    k3_rows, k3_launches = phase_window_sum()
    lap(10)

    errs = [r["err"] for r in list(tile_rows.values()) + captured] + pipeline_errs + ensemble_errs + dataset_k1_errs \
        + containers_k1_errs + j2k_k1_errs + avif_k1_errs + lossy_k1_errs
    kernel = {
        "name": "roi_align_fwd",
        "route": "cuda",
        "source": "deepemia_tpu_torch/kernels/csrc/roi_align_fwd.cu",
        "replaces": "deepemia_tpu/kernels/roi_align_pallas.py:351",
        # phases 3 (tile engine), 9 (pipeline), 11 (ensemble), 12 (the CLI's process, the device
        # measurement backend and the 4096² image), 13 (training from a dataset), 15 (the tasks the panel
        # and the wizard started, as their CLI logged them) and 16 (two tile shards, bf16 and int8; the
        # --chips 2 ensemble's process; the one-process training step and the CLI's training in an NCCL
        # group) and 17 (--task inference on two ranks, bf16 and int8, and in an NCCL group of one; both ranks of
        # the tensor-parallel step) and 18 (--task inference on the BigTIFF and FillOrder 2 rasters) and 19
        # to 22 (training and evaluation on the containers', the JPEG 2000, the lossless and the lossy AVIF
        # datasets), each counted from zero
        "launches": launches + pipeline_launches + ensemble_launches + cli_launches + dataset_k1 + entry_k1
        + shard_k1 + ranks_k1 + rank_k1 + tp_k1 + codings_k1 + containers_k1 + j2k_k1 + avif_k1 + lossy_k1,
        "max_abs_err": max(errs),
        # one 16-tile batch of the main path: its box-stage + mask-stage call
        "ms": sum(r["ms"] for r in captured),
        "plain_ms": sum(r["plain_ms"] for r in captured),
        "bound_ms": sum(r["bound_ms"] for r in captured),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in captured) else "operations",
        "library_ms": None,
    }
    backward = {
        "name": "roi_align_bwd",
        "route": "cuda",
        "source": "deepemia_tpu_torch/kernels/csrc/roi_align_bwd.cu",
        "replaces": "deepemia_tpu/kernels/roi_align_pallas.py:608",
        # phases 7 (train_on_batches() on ready batches), 13 (training from a dataset through the CLI), 16 (the
        # one-process step and the CLI's training in an NCCL group), 17 (both ranks of the tensor-parallel step)
        # and 19 to 22 (training on the containers', the JPEG 2000, the lossless and the lossy AVIF datasets)
        "launches": train_launches["roi_align_bwd"] + dataset_k2 + ranks_k2 + tp_k2 + containers_k2 + j2k_k2 + avif_k2
        + lossy_k2,
        "max_abs_err": max([r["err"] for r in bwd_rows] + dataset_k2_errs + containers_k2_errs + j2k_k2_errs
                           + avif_k2_errs + lossy_k2_errs),
        # one training step: its box-stage + mask-stage call, bf16
        "ms": sum(r["ms"] for r in bwd_rows),
        "plain_ms": sum(r["plain_ms"] for r in bwd_rows),
        "bound_ms": sum(r["bound_ms"] for r in bwd_rows),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in bwd_rows) else "operations",
        "library_ms": None,
    }
    k3, k3_f32 = k3_rows[torch.bfloat16], k3_rows[torch.float32]
    window = {
        "name": "window_sum",
        "route": "cuda",
        "source": "deepemia_tpu_torch/kernels/csrc/window_sum.cu",
        "replaces": "tools/bench_decouple.py:49",
        "launches": k3_launches,
        "max_abs_err": max(r["err"] for r in k3_rows.values()),
        # one call at the benchmark's shape: [256,256,256] bf16 -> the 8x16x256 window
        # (CUDA events around the call, median of six time_ms readings); *_device_ms:
        # the profiler's device time per launch; *_host_ms: host time per call;
        # *_f32: the same in float32; empty_*: the same launch of a kernel that does nothing
        "ms": k3["kernel_ms"],
        "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"],
        "library_ms": k3["library_ms"],
        "device_ms": k3["kernel_device_ms"],
        "host_ms": k3["kernel_host_ms"],
        "library_device_ms": k3["library_device_ms"],
        "library_host_ms": k3["library_host_ms"],
        "empty_ms": k3["empty_ms"],
        "empty_device_ms": k3["empty_device_ms"],
        "ms_f32": k3_f32["kernel_ms"],
        "plain_ms_f32": k3_f32["plain_ms"],
        "bound_ms_f32": k3_f32["bound_ms"],
        "library_ms_f32": k3_f32["library_ms"],
        "device_ms_f32": k3_f32["kernel_device_ms"],
        "host_ms_f32": k3_f32["kernel_host_ms"],
        "library_device_ms_f32": k3_f32["library_device_ms"],
        "library_host_ms_f32": k3_f32["library_host_ms"],
    }
    int8 = {
        "name": "int8_conv",
        "route": "cuda",
        "source": "deepemia_tpu_torch/kernels/csrc/int8_conv.cu",
        "replaces": "deepemia_tpu/models/quant.py:105",
        # phase 14's CLI runs, --quantized trunk and full (1 image each), counted from zero in the CLI's
        # process, phase 15's wizard task (--quantized trunk, 1 image), as its CLI logged them, phase 16's
        # two-shard int8 engine (one image) and phase 17's --quantized trunk runs (two ranks, an NCCL group of one;
        # 1 image each)
        "launches": int8_launches + entry_k4 + shard_k4 + rank_k4,
        "max_abs_err": int8_err,
        # one R50 trunk forward (its 53 convs) of a 16-tile batch of 1024² inputs, bf16: each distinct shape's
        # time_ms median x the convs of that shape; library_ms: torch._int_mm (the int32 product alone) at the
        # trunk's 1x1 stride-1 convs, beside K4's time over the same convs (ms_1x1); bf16_conv_ms: F.conv2d in
        # bf16 at every trunk shape; *_fpn: the same over the 8 FPN convs of `full`; trunk_fpn_s: the seconds
        # of one batch through trunk + FPN for --quantized none / trunk / full; device_ms: the profiler's device
        # time of K4 per call x the convs of that shape; host_ms: the wrapper's host time per call, the same way;
        # *_residual: the 16 conv3s, which add the shortcut; trunk_split: one trunk forward's device ms by kernel
        # (the profiler's: K4, K5 one pass, K5 two passes, the max slots' memsets, the other torch ops) and its
        # host-clock ms
        "ms": int8_sums["trunk_ms"],
        "plain_ms": int8_sums["trunk_plain_ms"],
        "bound_ms": int8_sums["trunk_bound_ms"],
        "bound_by": int8_sums["bound_by"],
        "library_ms": int8_sums["trunk_int_mm_ms"],
        "ms_1x1": int8_sums["trunk_ms_1x1"],
        "device_ms": int8_sums["trunk_device_ms"],
        "host_ms": int8_sums["trunk_host_ms"],
        "bf16_conv_ms": int8_sums["trunk_bf16_conv_ms"],
        "ms_fpn": int8_sums["fpn_ms"],
        "plain_ms_fpn": int8_sums["fpn_plain_ms"],
        "bound_ms_fpn": int8_sums["fpn_bound_ms"],
        "bf16_conv_ms_fpn": int8_sums["fpn_bf16_conv_ms"],
        "ms_residual": int8_sums["trunk_ms_residual"],
        "bound_ms_residual": int8_sums["trunk_bound_ms_residual"],
        "trunk_fpn_s": int8_times,
        "trunk_split": trunk_split,
    }
    quantizer = {
        "name": "int8_quant",
        "route": "cuda",
        "source": "deepemia_tpu_torch/kernels/csrc/int8_quant.cu",
        "replaces": "deepemia_tpu/models/quant.py:53",
        # phase 14's CLI runs, --quantized trunk and full, counted from zero in the CLI's process, and phase 15's
        # wizard task, as its CLI logged them, phase 16's two-shard int8 engine and phase 17's --quantized trunk
        # runs (two ranks, an NCCL group of one); one launch a quantized input
        # that comes with its producer's max (47 of a trunk forward's 49), two for the others (its max pass and
        # its quantize pass)
        "launches": quant_launches + entry_k5 + shard_k5 + rank_k5,
        "max_abs_err": quant_err,
        # one R50 trunk forward (its 49 quantized inputs) of a 16-tile batch of 1024² inputs, bf16: each distinct
        # input shape's time_ms median x the quantizations of that shape; plain_ms: the torch-op quantizer and the
        # layout; torch_chain_ms: the torch-op quantizer alone; device_ms: the profiler's device time of K5's
        # kernels; *_one_pass / *_two_pass: the same split by route; *_fpn: the same over the 8 FPN inputs of
        # `full`; launches_per_trunk_forward: the count one trunk forward of that batch adds (asserted)
        "ms": quant_sums["trunk_ms"],
        "plain_ms": quant_sums["trunk_plain_ms"],
        "bound_ms": quant_sums["trunk_bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "torch_chain_ms": quant_sums["trunk_torch_chain_ms"],
        "device_ms": quant_sums["trunk_device_ms"],
        "ms_fpn": quant_sums["fpn_ms"],
        "plain_ms_fpn": quant_sums["fpn_plain_ms"],
        "bound_ms_fpn": quant_sums["fpn_bound_ms"],
        "ms_one_pass": quant_sums["trunk_ms_one_pass"],
        "bound_ms_one_pass": quant_sums["trunk_bound_ms_one_pass"],
        "ms_two_pass": quant_sums["trunk_ms_two_pass"],
        "bound_ms_two_pass": quant_sums["trunk_bound_ms_two_pass"],
        "launches_per_trunk_forward": 51,
    }
    print(f"roi_align_fwd launches: tile engine {launches}, pipeline {pipeline_launches}, "
          f"ensemble {ensemble_launches}, CLI and phase 12 {cli_launches}, training from a dataset {dataset_k1}, "
          f"panel and wizard {entry_k1}, phase 16 {shard_k1 + ranks_k1}, phase 17 {rank_k1 + tp_k1}, phase 18 "
          f"{codings_k1}, phase 19 {containers_k1}, phase 20 {j2k_k1}, phase 21 {avif_k1}; roi_align_bwd "
          f"launches: ready batches {train_launches['roi_align_bwd']}, training from a dataset {dataset_k2}, phase 16 "
          f"{ranks_k2}, phase 17 {tp_k2}, phase 19 {containers_k2}, phase 20 {j2k_k2}, phase 21 {avif_k2}; int8_conv "
          f"launches: phase 14 "
          f"{int8_launches}, wizard {entry_k4}, phase 16 "
          f"{shard_k4}, phase 17 {rank_k4}; int8_quant launches: phase 14 {quant_launches}, wizard {entry_k5}, phase "
          f"16 {shard_k5}, phase 17 {rank_k5}",
          flush=True)
    print(f"total seconds {time.perf_counter() - t_start:.1f}", flush=True)
    print(json.dumps({"kernels": [kernel, backward, window, int8, quantizer]}), flush=True)
    print(card, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
