#!/usr/bin/env python3
"""Drive the PyTorch port's render, training, playback, command-line,
serving and multi-process paths on one CUDA card and check them.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is not 0):

1. card: needs CUDA; prints torch, the card's name and power limit; checks
   that float32 matmuls and cuDNN convolutions stay out of TF32.
2. build: compiles every CUDA kernel of the port from `csrc/` (one nvcc per
   source, in parallel) and prints nvcc's register / shared-memory lines
   and each kernel's threads, shared memory and resident blocks per SM;
   then the host libraries (`csrc/acap.cpp`, `csrc/image.cpp`,
   `csrc/vp8.cpp`, `csrc/vp8l.cpp`) with g++, each one's build seconds
   printed.
3. oracle: a small scene rendered on the card through `rasterize` agrees
   with the port's sequential oracle renderer.
4. slice: a mesh-bound model at the size of a trained config-2 model
   (icosphere subdivision 7: 327,680 faces, one Gaussian each, SH degree 3),
   perturbed from a seed to look trained, saved as a PLY, loaded back on
   the card and rendered at 1920x1080 from 8 orbit views through
   `mesh_model_arrays` -> `render`. Every kernel of the path must have
   launched there (launch counters set to 0 just before, read just after).
   A profiled pass over 3 more frames prints device time by kernel and the
   device's idle share.
5. kernels: K1 against its plain PyTorch version on the slice's own inputs
   (and an overflow-clamped config); then K2 and K3 on the same pair
   domains with seeded cotangents, against their plain versions, twice for
   bit-identity; each timed with CUDA events, with its bound (bytes or
   operations) computed from this run's data; K2's also with the (pair,
   warp) iterations its walk takes and the warp reductions it needs (here
   alone: the later phases' K2 checks skip these counts), K3's
   with the segment-length statistics of each shape, its time with the
   calls queued behind a sleep of the card (`queued_ms`) and its wrapper's
   host time per call (`host_ms`). Then K3 alone on the
   full-screen case: view 0's pair counts with 8 Gaussians set to one pair
   per tile of the image (8,160), seeded rows and a seeded permutation for
   `grouped_pos`.
6. train: config-2 training at full width. The slice model renders 24
   ground-truth views at 800x800; `MeshTrainer` trains a student from an
   icosphere-2 proxy (320 faces -> 327,680 Gaussians after the init
   subdivision, SH degree 3 from the first step) for 60 iterations with a
   shrunk schedule: the white-background opacity reset at 10, densify at 20
   and 30 (threshold lowered to 1e-5), an interval opacity reset at 20,
   then 30 iterations with no event. K1, K2 and K3 must each launch once per step (counters set to 0
   just before `train`, read just after); loss and parameters stay finite,
   no overflow, densify splits, the loss falls over the event-free steps.
   Step ms per event-free step; a profiled pass over 3 more steps. Then
   one more step with the kernels' wrappers recording their arguments, and
   K1, K2 and K3 held against their plain versions on those (the table at
   training capacity with its dead rows, cotangents from the real loss),
   timed and bounded as in phase 5; K2's rows must equal the step's.
7. playback: configs 3 and 5 of `tools/bench_playback.py` at 1920x1080.
   Config 3: the slice model bound to its icosphere-7 mesh (PLY + OBJ)
   through `ObjectDeformer`, view 0, 32 frames of the benchmark's twist
   through `make_playback_fn`; the identity frame against the slice's
   render, a rigid frame against the rigid motion (positions, Q cov Q^T),
   then frame ms, the deformation alone (`deformed_object_arrays`) and
   profiles of both. Config 5: the same object among two static
   icosphere-4 objects and a 100,000-Gaussian background PLY (437,920
   Gaussians) through `make_composite_playback_fn`; frames 0 and 8 equal
   to `SceneEditor.render` of the same deformed scene (max-abs <= 1e-6),
   K1 held against its plain version on frame 0's composite arguments,
   static precompute ms, frame ms, a profile. K1 once per frame, no
   overflow, finite images (counters set to 0 just before each frame loop,
   read just after). Then `cli.edit.main(..., "--device", "cuda")` on a
   small model directory: its two PNGs decode to the editor's frames.
8. pipeline: configs 2 and 4 trained from disk through the command lines,
   at 800x800. Config 2: a Blender set (24 train and 3 test views of the
   slice model, RGBA PNGs through the port's codec with alpha = 1 - final
   T, an icosphere-2 proxy); `cli.train_mesh` at full width (100,000 ->
   327,680 Gaussians, phase 6's shrunk schedule as flags) for 100
   iterations with a checkpoint at 50, then a second run from that
   checkpoint to 100, which must end with the first run's bits (checkpoint
   size and save / load seconds printed). Config 4: a COLMAP set (binary
   model through `io/colmap.write_model_binary`) of the slice model inside
   phase 7's 100,000-Gaussian background, masks the object's alpha,
   points3D the background's centres plus 1,000 of the object's Gaussians;
   `cli.train_mesh --is_exist_bg` for 100 iterations, `cli.train_bg` for
   500 (the neighbour prune at 50 must retire and the densify at 500 must
   add Gaussians), `cli.render --with_bg` on the test views, whose PNGs
   must equal an in-process render of the saved PLYs. K1, K2 and K3 once
   per step of each trainer and K1 once per rendered view (counters set to
   0 just before each command line, read just after); finite losses and
   parameters, no overflow. Step ms medians, dataset load seconds, and a
   profile of 3 more background steps (device operations, idle share).
   The host codecs on PNG_CODEC_VIEWS (3) of config 2's PNGs: each
   decoded by the C++ path (`csrc/image.cpp`) and by the plain numpy
   version, equal bytes; then each re-written with its rows cycling through
   filters 1-4 (the port's writer uses filter 0 alone) and decoded both
   ways again, equal to the view, its rows unfiltered both ways on their
   own: equal bytes, ms per view. (The training runs decode every view by
   the C++ path.)
   Then one more background step with the kernels' wrappers recording
   their arguments (the concatenated ~0.9 M-row table, background rows
   first, its pair domain, cotangents from the real loss), and K1, K2 and
   K3 held against their plain versions on those, timed and bounded as in
   phase 5; K2's rows must equal the step's.
9. eval: the reference's quality protocol through `cli.full_eval` on a JPEG
   COLMAP scene. The slice model rendered over white at 1920x1080 from 24
   orbit views, each written by `io/jpeg.write_jpeg` (quality 90, 4:2:0;
   the round trip's PSNR against the uint8 render must be >= 35 dB), a
   binary model with one PINHOLE camera and 1,000 of the object's
   Gaussians as points3D, an icosphere-2 proxy. `cli.full_eval --iterations
   100 --device cuda` with phase 8's shrunk schedule and capacities passed
   on to `train_mesh`, which reads 21 train and 3 test views through the
   `-r -1` ladder (1920 -> 1600x900 by `io/resample.py`); `render` the 3
   test views; `metrics`; then `cli.metrics --lpips_uncalibrated`. K1, K2
   and K3 once per train step and K1 once per rendered view (counters set
   to 0 just before each command line, read just after; full_eval's
   inner ones by difference); finite losses and parameters, no overflow;
   each gt PNG equal to `resize(read_jpeg(source))`; no overflow in
   `render`'s renders, and each of its PNGs equal to an in-process render
   of the trained model on `render`'s camera and capacities; results.json's
   PSNR and SSIM equal to an in-process computation on the written PNGs
   (1e-5); `LPIPS` null and `LPIPS_uncalibrated` finite. The share of each
   test view the object covers, beside that of phase 8's config-2 test
   views. Every JPEG decoded by the C++ path and the first EVAL_PLAIN_VIEWS
   (3) by the plain numpy version too (equal bytes), each test view
   resized both ways (equal bytes).
   JPEG decode s / MP and resample ms per image (C++ and plain), dataset
   load s, the
   step median and LPIPS ms per view at 1600x900, beside the card's name
   and power limit. Then one more training step at 1600x900 with the
   kernels' wrappers recording their arguments, and K1, K2 and K3 held
   against their plain versions on those, timed and bounded as in phase 5;
   K2's rows must equal the step's.
9b. progressive and lossless JPEGs: first the fixtures of
   `tests/data/jpeg_lossless/` (lossless JPEGs of every predictor, point
   transforms 0 and 2, restarts, gray / RGB / CMYK, one scan a component,
   subsampled components, with the SHA-256 and shape of PIL's array under
   the port's rule, recorded on a machine with PIL by
   `tools/make_jpeg_lossless_fixtures_torch.py`): `read_image` and
   `read_jpeg_plain` give the recorded digests, and the files PIL cannot
   load (JFIF or Adobe 1 RGB, Adobe 2 CMYK, a cut stream, restarts inside
   MCU rows) raise alike through both. Then the views of phase 9 that 9h
   takes from 9b (`reader_phase`: 0, 15 and 21) rendered again from the same
   cameras and written as progressive JPEGs (`write_jpeg(...,
   progressive=True)`: quality 90, 4:2:0, libjpeg's 10-scan progression).
   Each view decoded by `read_jpeg` (C++, `gm_jpeg_scan_progressive`):
   equal to phase 9's baseline file of the view decoded again; the CROP_9F
   centre of view 0, written the same way, decoded by `read_jpeg` and
   `read_jpeg_plain` to equal bytes; decode s / MP of both and of the
   baseline in the same run, beside the card's name and power limit and
   the host's CPU. A crafted file (view 0 with its last three scans, the AC
   refinements to bit 0, dropped) must raise "coefficients left unrefined"
   through both decoders. The rows of LOSSLESS_9B: view 0 at predictor 1
   and view 21 at predictor 7 as lossless JPEGs (`encode_jpeg_lossless`,
   RGB, point transform 0) decode by `read_jpeg` (C++, `gm_jpeg_lossless`)
   to exactly the rendered bytes, and their CROP_9F centres written the
   same way through both routes to the crop; s / MP beside the baseline
   files', plain / C++, bytes. 9h trains view 21 from its lossless file.
   Then arithmetic-coded JPEGs: the fixtures of `tests/data/jpeg_arith/`
   (SOF9 and SOF10 of every sampling, gray, Adobe-0 RGB, CMYK, YCCK,
   quality 100, restarts, DAC tables 0-3, one scan a component, refinements
   from Al 3; recorded by `tools/make_jpeg_arith_fixtures_torch.py`) give
   their digests through `read_image` and `read_jpeg_plain`, and the bad
   arithmetic code, the cut stream and the SOF11 files raise alike through
   both. The rows of ARITH_9B: view 0 as SOF9 and view 15 as SOF10
   (`write_jpeg(..., arithmetic=True)`: the coefficients of the view's
   Huffman files, quality 90, 4:2:0) decode by `read_jpeg` (C++,
   `gm_jpeg_arith_scan`) to exactly phase 9's baseline decode of the view,
   and their ARITH_CROP_9B centres written the same way through both
   routes to the same bytes as the crop's Huffman file; s / MP beside the
   baseline files', plain / C++, bytes against the Huffman file, write s.
   9h trains view 15 from its SOF10 file.
9c. new formats: phase 9's 24 views as the baseline JPEG files decode
   (1920x1080) written again: 6 LZW TIFFs with predictor 2, 3 with
   predictor 1, 3 PackBits TIFFs, 4 16-bit LZW TIFFs (each sample x 257,
   predictor 2), 4 GIFs and 2 RLE8 BMPs on a fixed 256-entry palette (the
   views quantized in numpy; two GIFs interlaced), 2 RLE4 BMPs on a
   16-entry one (`io/tiff.py`, `io/gif.py`, `io/bmp.py` writers; the LZW
   encoder `gm_lzw_encode`). Each view decoded by `read_image` (C++:
   `gm_lzw_decode`, `gm_packbits_decode`, `gm_bmp_rle`) to the bytes
   written, or the palette expansion of the indices written; one view of
   each format decoded by the plain versions, equal bytes; s / MP (C++ and
   plain), file bytes and write s by format beside the card's name and
   power limit and the host's CPU. A TIFF cut inside its last LZW strip
   and a GIF with a code past the LZW table raise the same ValueError
   through both decoders.
9d. lossy WebP: first the fixtures of `tests/data/webp/` (PIL- and
   `write_webp`-written files with the SHA-256 of PIL's RGB and of the
   planes of the library PIL decodes with, recorded on a machine with PIL):
   `read_image`'s RGB and the C++ planes (`gm_vp8_decode`) give the recorded
   digests, the plain decoder (`vp8_decode_plain`, `yuv_to_rgb_plain`) the
   same bytes, the file cut by 2 bytes raises "cut short" through both and
   the one cut by 3 decodes to its digest. Then phase 9's 24 views as the
   baseline JPEG files decode (1920x1080: 1080 is not a multiple of 16)
   written by `write_webp` (`gm_vp8_encode`) in the rows of WEBP_9D: 4
   segments with delta quantizers and the normal filter; the simple filter
   on 2 partitions; sharpness 5 with filter-level deltas on 8 partitions at
   quantizer 4 (DCT_CAT6); no filter at quantizer 110 (skipped
   macroblocks); 4 absolute segments on 4 partitions in `VP8X` with ICCP
   and EXIF chunks. Each view's planes decode to the writer's
   reconstruction and `read_image` gives their `gm_vp8_rgb`; each row's
   PSNR against the views written is held to its bound; one view a row at
   480x270 (the port's resize) decoded by the plain version, equal bytes;
   s / MP (C++ and plain), file bytes and write s by row beside the card's
   name and power limit and the host's CPU.
9e. WebP with alpha, lossless and animated: first the fixtures of
   `tests/data/webp/rgba/` (PIL- and writer-written VP8L, VP8X + ALPH + VP8
   and animated files and cuts, with the SHA-256 and shape of PIL's array,
   recorded on a machine with PIL): `read_image` and the plain version
   (`vp8l_decode_plain`, `alpha_decode_plain`) give the recorded digests,
   the cuts that raise raise "cut short" through both. Then phase 8's 27
   config-2 views (800x800 RGBA PNGs, alpha = 1 - final T) written by
   `write_webp` / `write_webp_animation` in the rows of WEBP_9E: lossless
   with subtract-green, predictor and cross-colour transforms, a 10-bit
   colour cache and backward references (every view); lossless with all
   four transforms on a copy quantized to 16 colours (bundled); lossy +
   ALPH compressed with each filter (none, horizontal, vertical by a
   predictor-coded alpha, gradient); lossy + raw ALPH; each view the first
   frame of a 2-frame animation at an offset. Each lossless view decodes to
   exactly the RGBA written (phase 8's, or the quantized copy), each lossy
   one to the writer's reconstruction (its planes through the plain
   `yuv_to_rgb_plain`) with the exact alpha, each DECODES_9E times; the 200x200
   centre of one view a row written with the row's settings decodes through
   the plain version to the C++'s bytes; s / MP, its ratio to phase 9's
   baseline JPEG in the same run, plain / C++, bytes and write s by row
   beside the card's name and power limit and the host's CPU. Then the
   lossless row as a Blender set (phase 8's transforms, `.webp` views) is
   loaded as `cli.train_mesh` loads it (its flags, `Scene`,
   `DeviceDataset.from_cameras` on the card; `training_dataset`): every
   training target, mask and camera centre equal to phase 8's from its PNGs.
9f. TIFF layouts, CMYK and Zstandard: first the fixtures of `tests/data/tiff/`
   (PIL- and writer-written JPEG-in-TIFF, LZMA, tiled, planar and CMYK TIFFs
   and CMYK / YCCK JPEGs, with the SHA-256 and shape of PIL's array, of its
   `convert("RGB")` for CMYK, recorded on a machine with PIL) and of
   `tests/data/tiff_zstd/` (PIL's Zstandard TIFFs of every mode, libzstd's
   frames at levels -5 to 22 and window logs 10-27, and the forms libtiff
   reads or fails on, recorded by `tools/make_tiff_zstd_fixtures_torch.py`):
   `read_image` and the plain route give the recorded digests, or raise
   alike where PIL fails. Then phase 9's 24 views written in the rows of
   LAYOUTS_9F: tiled 256x256 LZW with predictor 2, tiled 16-bit Deflate
   with predictor 2, planar LZW with predictor 2, Zstandard strips with
   predictor 2 (`gm_zstd_encode`), planar PackBits, tiled 16-bit Zstandard
   with predictor 2, planar Zstandard, JPEG-in-TIFF YCbCr 4:2:0 in strips of
   16 rows and in 256x256 tiles, JPEG-in-TIFF RGB, LZMA, CMYK LZW TIFFs of
   each view's CMYK separation (`cmyk_of`), CMYK JPEGs (Adobe, inverted) and
   YCCK JPEGs at 4:2:0. Each lossless view decodes by `read_image` to
   exactly the samples written (CMYK: their `cmyk_to_rgb`), each JPEG view
   to the plain route's decode; the CROP_9F centre of one view a row,
   written with the row's settings, decodes through the plain route to the
   C++'s bytes; s / MP, its ratio to phase 9's baseline JPEG in the same
   run, plain / C++, bytes (Zstandard rows: also as a multiple of the same
   view's Deflate file with the row's settings) and write s by row beside
   the card's name and power limit and the host's CPU.
9g. PNM, TGA, QOI, SGI and PCX: first the fixtures of `tests/data/raw/`
   (PIL-written files and the forms PIL reads and does not write, with the
   SHA-256 and shape of PIL's array under the port's rule: B15, B16, B19,
   B20; recorded on a machine with PIL by `tools/make_raw_fixtures_torch.py`):
   `read_image` and the plain route give the recorded digests. Then phase
   9's 24 views written in the rows of RAW_9G (`io/pnm.py`, `io/tga.py`,
   `io/qoi.py`, `io/sgi.py`, `io/pcx.py` writers): P6, ASCII P3, a 16-bit
   P5 whose high byte is the view's green (B19), raw 24-bit TGAs
   bottom-up, RLE 32-bit TGAs top-down with 8 alpha bits, RLE colour-mapped
   TGAs (B15), a raw 32-bit TGA whose descriptor has no alpha bits and
   whose fourth byte is 0 (B20), QOI RGB and RGBA, RLE SGI, 16-bit
   verbatim SGI, PCX 8 x 3 and 8 x 1 with a palette (B15). Each view
   decodes by `read_image` (C++: `gm_tga_rle`, `gm_qoi_decode`,
   `gm_sgi_rle`, `gm_pcx_rle`) to the samples written (palette views to
   the expansion of the indices, B19 to the green, B20 to 3 channels); the
   CROP_9F centre of one view a row decodes through the plain route to the
   C++'s bytes (PNM has no C++ route, so there it is 1); s / MP, its ratio
   to phase 9's baseline JPEG in the same run, plain / C++, bytes a view and
   their ratio to phase 9's JPEG files, and write s by row beside the card's
   name and power limit and the host's CPU.
9i. DIB, ICO, CUR, DCX and ICNS: first the fixtures of
   `tests/data/containers/` (PIL-written files and the forms PIL reads and
   does not write, with the SHA-256 and shape of PIL's array under the
   port's rule: B15, B16, B23; recorded on a machine with PIL by
   `tools/make_container_fixtures_torch.py`): `read_image` and the plain
   route give the recorded digests, and `gm_icns_rle` its plain walk's
   planes on the ICNS fixtures that hold run-length images (plain / C++
   printed). Then phase 9's 24 views written in the rows of CONTAINERS_9I
   (`io/bmp.py`, `io/ico.py`, `io/pcx.py` writers): 24-bit DIBs, 32-bit
   BI_BITFIELDS RGBA DIBs, ICOs of a PNG frame whose directory says 0 x 0
   (RGB and RGBA), of a 32-bit BMP frame, of a 24-bit one with an AND mask
   (the ellipse inscribed in the view opaque), of an 8-bit palette one
   (B15) and of a 32-bit one whose fourth bytes are 0 (B23), 24-bit CURs,
   and DCXs of two 8 x 3 pages. Each view decodes by `read_image` to the
   samples written (a palette view to its expansion, a masked or B23 view
   to the mask's 0 / 255 alpha); the CROP_9F centre of one view a row
   decodes through the plain route to the C++'s bytes; s / MP, its ratio
   to phase 9's baseline JPEG in the same run, plain / C++, bytes a view
   and their ratio to phase 9's JPEG files, and write s by row beside the
   card's name and power limit and the host's CPU. ICNS holds no 1080p
   view, so it is checked on its fixtures only.
9j. SUN, MSP, XBM, XPM and PSD: first the fixtures of
   `tests/data/rle_text/` (PIL-written files and the forms PIL reads and
   does not write, with the SHA-256 and shape of PIL's array under the
   port's rule: B14, B15, B16, and the oracles of B24, B25, B27, B28, B29;
   recorded on a machine with PIL by `tools/make_rle_text_fixtures_torch.py`):
   `read_image` and the plain route give the recorded digests, and
   `gm_sun_rle` / `gm_msp_rle` their plain walks' bytes on the fixtures
   that hold byte-encoded Sun rasters and MSP version 2 rows (plain / C++
   printed). Then phase 9's 24 views written in the rows of RLE_TEXT_9J
   (`io/sun.py`, `io/msp.py`, `io/xbm.py`, `io/xpm.py`, `io/psd.py`
   writers): raw and byte-encoded 24-bit Sun rasters, byte-encoded 8-bit
   ones with a colour map of 9c's fixed palette (B15), MSP versions 1 and 2
   and XBMs of the view's green thresholded (B16), XPMs of 9c's 256-colour
   palette (B15) and of 8,000 colours at 2 characters a pixel, raw and
   PackBits RGB PSDs and PackBits CMYK PSDs of the view's separation (B14).
   Each view decodes by `read_image` to the samples written (a palette
   view to its expansion, a 1-bit view to 0 / 255, CMYK to its
   `cmyk_to_rgb`); the CROP_9F centre of one view a row decodes through
   the plain route to the C++'s bytes (XBM and XPM have one route); s /
   MP, its ratio to phase 9's baseline JPEG in the same run, plain / C++,
   bytes a view and their ratio to phase 9's JPEG files, and write s by
   row beside the card's name and power limit and the host's CPU.
9k. FLI, IPTC, IM, IMT and GBR: first the fixtures of
   `tests/data/raw_samples/` (PIL-written IM files and the port's writers'
   files of the five formats, with the SHA-256 and shape of PIL's array
   under the port's rule: A2, B7, B14, B15, B16, B30; recorded on a machine
   with PIL by `tools/make_raw_sample_fixtures_torch.py`): `read_image` and
   the plain route give the recorded digests, and `gm_fli_frame` its plain
   walk's planes on the FLI fixtures (plain / C++ printed). Then phase 9's
   24 views written in the rows of RAW_SAMPLE_9K (`io/fli.py`,
   `io/iptc.py`, `io/im.py`, `io/imt.py`, `io/gbr.py` writers): FLIs of
   BRUN on 9c's 256-colour palette (B15), FLCs of COPY on it at 64 levels
   (B15), raw and JPEG gray IPTC records of the view's green, IM files of
   RGB, of 9c's indices with a colour `Lut` (B15), of YCC samples (B30),
   of 16 bits whose high byte is the green (B7) and of the CMYK separation
   (B14), IMTs of the green, and GBRs of the green (version 1) and of RGBA
   with 9i's ellipse as alpha (version 2). Each view decodes by
   `read_image` to the samples written under the port's rule (the IPTC
   JPEG to its own decode); the CROP_9F centre of one view a row decodes
   through the plain route to the C++'s bytes (`gm_fli_frame` against its
   plain walk on the FLI rows; the others have one route); s / MP, its
   ratio to phase 9's baseline JPEG in the same run, plain / C++, bytes a
   view and their ratio to phase 9's JPEG files, and write s by row beside
   the card's name and power limit and the host's CPU.
9l. PIXAR, MCIDAS, XV thumbnails, FITS, SPIDER and FTEX: first the
   fixtures of `tests/data/raw_samples/` of these formats (the port's
   writers' files, PIL's SPIDER file and FTEX textures of PIL's DXT1 DDS
   blocks, with the SHA-256 and shape of PIL's array under the port's rule:
   B7, B15, B32; recorded on a machine with PIL by
   `tools/make_raw_sample_fixtures_torch.py`): `read_image` and the plain
   route give the recorded digests, the SPIDER file (float samples: B21) is
   refused alike through both, and `gm_bc1_decode` gives `_bc1_plain`'s
   RGBA on the DXT1 fixtures (plain / C++ printed). Then phase 9's 24 views
   written in the rows of SAMPLE_TEXTURE_9L (`io/pixar.py`, `io/mcidas.py`,
   `io/fits.py`, `io/ftex.py`, `io/xvthumb.py` writers): PIXAR RGB, McIdas
   areas of the green in 1-byte samples and in 2-byte ones whose high byte
   is the green (B7), FITS of the green in 8 bits, in unsigned 16 bits
   (BZERO 32768) whose high byte is the green (B32, B7) and in PIL's
   GZIP_1 tile form, FTEX DXT1 (the port's BC1 encoder; RGBA) and raw RGB
   textures, and XV thumbnails of the view's RGB332 levels (B15). Each view
   decodes by `read_image` to the samples written under the port's rule
   (a DXT1 view to its encoder's RGBA); the CROP_9F centre of one view a row
   decodes through the plain route to the C++'s bytes (`gm_bc1_decode`
   against `_bc1_plain` on the DXT1 row; the others have one route); s /
   MP, its ratio to phase 9's baseline JPEG in the same run, plain / C++,
   bytes a view and their ratio to phase 9's JPEG files, and write s by
   row beside the card's name and power limit and the host's CPU.
9m. DDS and BLP: first the fixtures of `tests/data/textures/` (PIL's DDS
   and BLP writers' files, the port's writers' and hand-made blocks, with
   the SHA-256 and shape of PIL's array under the port's rule: A2, B15,
   B35-B37, B38's oracle; recorded on a machine with PIL by
   `tools/make_texture_fixtures_torch.py`): `read_image` and the plain
   route give the recorded digests (DX10 BC6H of every mode, unsigned and
   signed, included), the B34 and raw BGRA fixtures are refused alike
   through both, and `gm_bcn_decode` gives `decode_plain`'s bytes on every
   fixture's blocks (BC1-BC5, BC5S, BC6H, BC6HS, BC7 and BLP's DXT1, DXT3
   and DXT5; plain / C++ printed by kind). Then phase 9's 24 views written
   in the rows of TEXTURE_9M (`io/dds.py`, `io/blp.py` writers): DDS DXT1
   (RGBA), DXT5 with 9i's ellipse as the alpha, DX10 BC7 of mode 6, BC4 of
   the view's `convert("L")`, BC5 (R, G), DX10 BC6H unsigned and signed
   (`encode_bc6h`, mode 0x03) and 16-bit 565 masks; BLP1 JPEG of three
   components, BLP2 DXT1 of alpha depth 0 and BLP2 palette on 9c's 256
   colours. Each view decodes by `read_image` to what
   its writer says; the CROP_9F centre of one view a row decodes through
   the plain route to the C++'s bytes; s / MP, its ratio to phase 9's
   baseline JPEG in the same run, plain / C++, bytes a view and their
   ratio to phase 9's JPEG files, and write s by row beside the card's name
   and power limit and the host's CPU.
9h. the reader phases' shared training: one COLMAP scene of phase 9's 24
   cameras whose view i is the file phase `reader_phase(i)` (9m for the
   views of READER_9M, 11, 13 and 18; otherwise READER_PHASES[(5 i + 6 (i
   // 8)) % 9] over 9b, 9c, 9d, 9f, 9g, 9i, 9j, 9k and 9l: each view 5
   phases on from the one before, each octet one phase on, so that the
   test views 0, 8 and 16 fall to 9b, 9c and 9d and each of the ten phases
   gives two or three training views, none of a row with an alpha) wrote
   for it (among the training views a BC6H texture of 9m, 9b's lossless
   and arithmetic-coded JPEGs and 9f's Zstandard TIFF at least), or phase
   9's JPEG where that file
   decodes with an alpha
   (an alpha makes a mask, and `DeviceDataset` stacks masks only where the
   shuffled first view has one, as the JAX trainer does);
   `cli.train_mesh --device cuda` on it for PROGRESSIVE_ITERS steps with
   phase 9's shrunk schedule and capacities: K1, K2 and K3 once a step
   (counters set to 0 just before, read just after), finite losses and
   parameters, no overflow, the cameras equal to phase 9's, the training
   target of every view that decodes to phase 9's baseline decode equal to
   phase 9's and of every other one to the port's resize of its decode (as
   `_load_image` makes it: gray to RGB). Each reader phase prints its own
   seconds in a `[done]` line.
10. serve and shard, at full width. (a) The host deformation-gradient
   extractor (`edit/native_acap.py`, C++ / OpenMP, built by g++) on the
   slice's icosphere-7 mesh and phase 7's largest twist frame: against the
   card's `deformation_gradients` in float64 (1e-4) and beside its float32
   path (within `RS_F32_FLOOR`); a rigid frame made in float64 gives R = Q
   (1e-4), one made in float32 within `RIGID_F32_BAR`; host ms per call
   beside the card's deformation ms. (b)
   `ViewerServer` on 127.0.0.1, port 0, serving `editor_render_fn` of the
   slice model at 1920x1080: 8 `GET /frame` at the slice's orbit angles,
   each PNG equal to the in-process render quantised (0 levels), K1 once per
   frame (counters set to 0 just before the requests, read just after), no
   overflow, `/state` 8 frames, a 500 for a render that raises; request ms
   split into render and encode. (c) `GM_DEVICE=cuda GM_E2E_ITERATIONS=10
   bash examples/synthetic_e2e_torch.sh` (E2E_ITERATIONS: the script's 400
   cut to 10): exit 0, renders, results.json, edit frames; each step's
   seconds from the script's `[e2e-step]` marks. (d) View 0 as 4 bands
   (`parallel/train_step.rasterize_band`, one at a time), stitched equal
   to the full render (2e-5). (e) A rehearsal of
   the (data, tile) regime: 4 ranks (2x2) on the one card over gloo from a
   FileStore, config 2 at 800x800 from the phase-6 student's state: the
   first step against a single-process reference over the same two views
   (loss 1e-4 relative, parameters 5e-4 of each leaf's largest, grad_accum
   1e-5, denom exact), SHARD_STEPS (16) more steps with a reset at 2, densify at 3 and 6
   and a reset at 6 (the ranks' state hashes all-gathered after each event
   and at the end, equal), K1-K3 once per rank and step, finite losses that
   fall over the event-free steps; then one more step with the band
   arguments recorded and, on rank 0, K1-K3 held against their plain
   versions there, timed and bounded as in phase 5 (the `band_*` keys). An
   nccl world of 4 ranks on one card raises. On a host with a card per rank
   the same ranks run over nccl instead, rank r on card r (`rank_plan`),
   and the parent checks that nccl initialised. The ranks of (e) and (f) go
   on to (g) in the same processes, each phase in its own process group
   (one process start a rank for both). (f) Config-3 playback at
   1080p through `make_sharded_playback_fn` on the same ranks, 2 frames a
   call, 2 bands each, every frame within 2e-5 of the single-process
   frame. The parent joins each rank with a timeout and fails on any
   rank's failure; its wall times are a rehearsal, not a multi-card speed.
   (g) The Gaussian-table shard: the phase-6 student's table dealt over 4
   shards, one emulated rank (`emulate_d=4`: forward and backward in this
   process) timed; then, in (e)'s 4 rank processes once (e) and (f) are
   done, a new group over gloo (or nccl, as in (e)),
   each rank with its shard and one band: step 1 against a single-process step
   on the dealt table (loss 1e-4 relative, parameters 5e-4 of each leaf's
   largest, grad_accum 1e-5, denom exact), 8 steps with resets at 2 and 6
   and densifies at 3 and 6 (each threshold the 2,000th largest grads_avg
   of the gathered table, so that no per-shard cap binds; the summed
   n_split equal to a single-process `densify_and_split` of the gathered
   table; the vertex pools' hashes equal on every rank), no overflow of
   any kind, K1 1, K2 1 and K3 2 launches per rank and step (counters set
   to 0 just before, read just after); a per-rank checkpoint, GSHARD_MORE
   (1) more steps, and fresh trainers resumed from it for as many, equal
   bit for bit; the
   exchange alone timed (EXCHANGE_REPS: once); one more step with the
   arguments recorded, and on
   the rank that received the most pairs K1, K2 and the receiver's K3 held
   against their plain versions and the owner's K3 against a float64
   `index_add_` (the `gshard_*` keys). Prints the bytes sent per rank and
   step, the received live pairs beside the slots, step ms per rank.
11. quality: the config-2 quality protocol of `tools/quality_run_torch.py`
   in its SMALL mode (128x128, 16 poses of the icosphere-2 teacher, 2 of
   them test views, an icosphere-1 proxy, 300 iterations, evals at 100 and
   300), in-process on the card once for each seed of QUALITY_SEEDS: K1 once
   per training step, teacher view and rendered test view, K2 and K3 once per
   step (counters set to 0 just before each run, read just after); finite
   losses and trajectory, the test PSNR rising from 100 to 300, and the
   final test PSNR within QUALITY_BAR_DB of the JAX package's SMALL run
   (`results/config2_quality_smoke.json`, read as JSON). Then the quality
   step: a `MeshTrainer` at the PROTOCOL run's shapes (448x448 views of the
   icosphere-4 teacher, the 1,600-face uv-sphere proxy -> 102,400
   Gaussians, the tool's flags: `max_per_tile` 768, 6 pairs and 3 rows per
   Gaussian, SH degree 2) takes one step with the kernels' wrappers
   recording their arguments, and K1, K2 and K3 are held against their
   plain versions on those, timed and bounded as in phase 5 (the `quality_*`
   keys). `python3 chip_smoke.py --quality-step WORK` does the same on the
   table of the newest checkpoint of a PROTOCOL run in WORK, at that run's
   `max_per_tile`.

12. tools: the port's measurement tools in-process on the card at their
   full width, each through its `main()`, artifacts in the phase's
   temporary directory: `bench_torch.py` (1080p, 100,000 Gaussians, 10
   steps), `tools/profile_raster_torch.py --prefix` (TOOL_REPS calls a row)
   and `tools/bench_playback_torch.py` (configs 3, 5 and 5's tile axis over
   TOOL_FRAMES frames, TOOL_STEPS4 config-4 steps). Their JSON lines and
   artifacts parse; the bench has no overflow and launches K1, K2 and K3
   once a step; its `num_rendered` equals the prefix table's F7; every
   playback frame and the config-4 steps have no overflow; the covariances
   rotate; K1-K3 launched (counters set to 0 just before the tools, read
   just after: the `tools` launches). Then one more bench step with the
   kernels' wrappers recording their arguments, and K1, K2 and K3 held
   against their plain versions on those, timed and bounded as in phase 5
   (the `bench_*` keys).
13. scaling: the two scaling tools in-process on the card at full width
   (1080p, 100,000 Gaussians), artifacts in the phase's directory:
   `tools/bench_scaling_torch.py` at D = 1 and 8 (SCALING_STEPS steps an
   item; `--profile critical`: device busy ms of the plain and training
   steps and each D's critical band and emulated ranks, the ones printed)
   and `tools/bench_sharded_torch.py`. Their JSON lines and artifacts
   parse; the D = 1 band renders the bench's 765,920 pairs and at every D
   the bands' live pairs sum to them and equal the histogram; no band
   overflows at the timed capacities and no emulated rank's send overflows;
   the (1, 1) steps' losses and gradients (and the (1, 1) training step's
   parameters) agree with the plain step's within the multi-rank bars of
   PERF.md section 2; no process group is left; K1-K3 launched (the
   `scaling` launches). Then K1, K2 and K3 held against their plain
   versions, timed and bounded as in phase 5, on the D = 8 critical band's
   step (the `scaling_band_*` keys) and on the D = 8 critical emulated
   rank's at the design's send capacity, whose K3 writes the D x cap-row
   receiver table (`scaling_gshard_*`; the owner's K3
   `scaling_gshard_owner_*`).

The host codecs' figures (JPEG decode s / MP, PNG unfilter ms per view,
resize ms, C++ and plain, and the two dataset loads) are printed on one
line with the card's name and power limit and the host's CPU model and
core count. The last three lines: the `kernels` JSON, the card's name and
power limit (nvidia-smi), and the device JSON.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import json
import math
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import types
import zlib

import numpy as np

SEED = 0
WIDTH, HEIGHT = 1920, 1080
N_VIEWS = 8
SUBDIV = 7             # 20 * 4**7 = 327,680 faces
SH_DEGREE = 3
TIMED_LAUNCHES = 20
SLEEP_CYCLES = 10_000_000   # ~5 ms at the H100's clock (queued_ms, host_ms)
# the plain K1 and K2 walk each pair of the largest tile in Python, seconds a
# call at a step's shapes: each is timed on its one comparison call (cuda_call)

# playback phase: configs 3 and 5 (tools/bench_playback.py) at 1080p
PLAYBACK_FRAMES = 32
TWIST_AMP = 0.6
SIDE_SUBDIV = 4        # two static icosphere-4 objects (5,120 faces each)
SIDE_OFFSETS = ((2.2, 0.6, 0.0), (-2.2, -0.6, 0.3))
BG_GAUSSIANS = 100_000
CONFIG5_GAUSSIANS = 20 * 4 ** SUBDIV + 2 * 20 * 4 ** SIDE_SUBDIV + BG_GAUSSIANS
CLI_SUBDIV = 5         # 20,480 faces
# identity frame against the slice's render (K1's bars, mean 1e-4); rigid
# frame: positions, covariances over each Gaussian's largest entry; the
# composite frame against the editor's render of the concatenated scene
IDENTITY_MAX, IDENTITY_MEAN = 4e-3, 1e-4
RIGID_POS, RIGID_COV_REL = 1e-4, 2e-2
COMPOSITE_MAX = 1e-6

# training phase: config 2 at the NeRF-synthetic size
TRAIN_SIZE = 800
TRAIN_VIEWS = 24
TRAIN_ITERS = 60
PROXY_SUBDIV = 2       # 320 faces
INIT_TARGET = 100_000  # config 2: subdivide past 100K (train_mesh_gaussian.py:60)

# pipeline phase: configs 2 and 4 trained from disk through the command lines
PIPE_SIZE = 800
PIPE_FOVX = math.radians(60.0)
PIPE_VIEWS, PIPE_TEST_VIEWS = 24, 3
PIPE_ITERS = 100       # train_mesh runs; the checkpoint at half
BG_ITERS = 500         # train_bg: one densify (every 500 iterations)
BG_DENSIFY_FROM = 100
BG_PRUNE_AT = 50       # the neighbour prune
BG_SURFACE_POINTS = 1000
PNG_CODEC_VIEWS = 3    # config 2's views also decoded (and unfiltered) by the plain PNG route

# eval phase: the quality protocol (full_eval) on a JPEG COLMAP scene
EVAL_WIDTH, EVAL_HEIGHT = 1920, 1080   # -r -1 caps the width: 1600x900
EVAL_FOVX = math.radians(60.0)
EVAL_VIEWS = 24                        # llffhold 8: 21 train, 3 test
EVAL_QUALITY = 90
EVAL_ITERS = 100
EVAL_MIN_PSNR = 35.0                   # the JPEG round trip against the render
EVAL_PLAIN_VIEWS = 3                   # the views also decoded by the plain JPEG route
PROGRESSIVE_ITERS = 20                 # 9h: the reader phases' shared train_mesh
# phase 9c: phase 9's views written again, (format, views) in turn
FORMATS_9C = (("tiff_lzw_p2", 6), ("tiff_lzw_p1", 3), ("tiff_packbits", 3),
              ("tiff16_lzw_p2", 4), ("gif", 4), ("bmp_rle8", 2), ("bmp_rle4", 2))
LEVELS_256 = (8, 8, 4)                 # phase 9c's fixed palettes: steps of R, G, B
LEVELS_16 = (2, 4, 2)
# phase 9d: phase 9's views as lossy WebPs, (row, views, write_webp's settings,
# the least PSNR against the view written, dB) in turn
WEBP_9D = (
    ("4seg_delta_normal24", 8, dict(quality_index=30, segments=4, filter="normal", level=24,
                                    sharpness=0, partitions=1), 30.0),
    ("simple32_2parts", 4, dict(quality_index=40, filter="simple", level=32, partitions=2),
     30.0),
    ("4seg_sharp5_deltas_8parts_q4", 4, dict(quality_index=4, segments=4, filter="normal",
                                             level=20, sharpness=5, ref_lf_delta=(2, 0, 0, 0),
                                             mode_lf_delta=(4, 0, 0, 0), partitions=8), 34.0),
    ("unfiltered_q110", 4, dict(quality_index=110, filter="none"), 24.0),
    ("4seg_absolute_normal16_4parts_vp8x", 4, dict(
        quality_index=20, segments=4, absolute=True, filter="normal", level=16, partitions=4,
        icc=b"\x00" * 132, exif=b"Exif\x00\x00MM\x00*" + bytes(8)), 30.0),
)
WEBP_PLAIN_SIZE = (480, 270)           # phase 9d's plain decodes: one view a row, resized

# phase 9e: phase 8's RGBA views as WebPs, (row, views, encode_webp's settings) in turn;
# "quantized" rows write a copy of 16 colours or fewer, "animation" rows each view as
# the first frame of 2 at an offset of ANIM_OFFSET on a canvas that much larger
LOSSLESS_9E = dict(transforms=("subtract_green", "predictor", "cross_color"), cache_bits=10,
                   predictor_bits=4, cross_bits=4, cross_color="seeded")
WEBP_9E = (
    ("lossless_3transforms_cache10", None, dict(lossless=True, vp8l_options=LOSSLESS_9E)),
    ("lossless_quantized_all4", 4, dict(lossless=True, vp8l_options=dict(
        transforms=("palette", "predictor", "cross_color", "subtract_green"),
        predictor_bits=3))),
    ("lossy_alph_none", 2, dict(quality_index=20, alpha_compression=1, alpha_filter=0)),
    ("lossy_alph_horizontal", 2, dict(quality_index=20, alpha_compression=1, alpha_filter=1)),
    ("lossy_alph_vertical", 2, dict(quality_index=20, alpha_compression=1, alpha_filter=2,
                                    alpha_options=dict(transforms=("predictor",),
                                                       cache_bits=4))),
    ("lossy_alph_gradient", 2, dict(quality_index=20, alpha_compression=1, alpha_filter=3)),
    ("lossy_alph_raw", 2, dict(quality_index=20, alpha_compression=0)),
    ("animation_lossy_alph", 3, dict(quality_index=20, alpha_compression=1, alpha_filter=1)),
)
ANIM_OFFSET = (4, 2)
DECODES_9E = 3                         # phase 9e decodes each view this many times
WEBP_9E_PLAIN = 200                    # phase 9e's plain decodes: the centre crop of one view a row

# phase 9f: phase 9's views as tiled, planar, JPEG-compressed, LZMA, Zstandard and CMYK
# TIFFs and CMYK / YCCK JPEGs, (row, views, the writer's settings) in turn; "tiff16" rows
# write 16-bit samples (each 8-bit one times 257), "cmyk" rows the view's CMYK separation;
# 9h takes view 6 (zstd_p2) and view 12 (jpeg_ycbcr420_strips16)
TILE_9F = (256, 256)
LAYOUTS_9F = (
    ("tiled_lzw_p2", 2, dict(compression="lzw", predictor=2, tile=TILE_9F)),
    ("tiled_tiff16_deflate_p2", 2, dict(compression="deflate", predictor=2, tile=TILE_9F)),
    ("planar_lzw_p2", 2, dict(compression="lzw", predictor=2, planar=True)),
    ("zstd_p2", 2, dict(compression="zstd", predictor=2)),
    ("planar_packbits", 1, dict(compression="packbits", planar=True)),
    ("tiled_tiff16_zstd_p2", 1, dict(compression="zstd", predictor=2, tile=TILE_9F)),
    ("planar_zstd", 1, dict(compression="zstd", planar=True)),
    ("jpeg_ycbcr420_strips16", 2, dict(compression="jpeg", ycbcr=True, rows_per_strip=16,
                                       quality=EVAL_QUALITY)),
    ("jpeg_ycbcr420_tiles", 2, dict(compression="jpeg", ycbcr=True, tile=TILE_9F,
                                    quality=EVAL_QUALITY)),
    ("jpeg_rgb", 1, dict(compression="jpeg", quality=EVAL_QUALITY)),
    ("lzma", 2, dict(compression="lzma")),
    ("cmyk_tiff_lzw", 2, dict(compression="lzw", cmyk=True)),
    ("cmyk_jpeg_adobe", 2, dict(quality=EVAL_QUALITY)),
    ("ycck_jpeg_420", 2, dict(quality=EVAL_QUALITY, ycck=True)),
)
CROP_9F = (480, 272)                   # 9b, 9f, 9g: the plain decodes' centre crop of a view
# phase 9b's lossless JPEG rows: (predictor, view) in turn, RGB at point transform 0; 9h
# takes view LOSSLESS_9B_TRAIN's lossless file in place of its progressive one
LOSSLESS_9B = ((1, 0), (7, 21))
LOSSLESS_9B_TRAIN = 21
# phase 9b's arithmetic-coded JPEG rows: (frame, view) in turn, the coefficients of the
# view's Huffman files; 9h takes view ARITH_9B_TRAIN's file in place of its progressive one
ARITH_9B = (("sof9", 0), ("sof10", 15))
ARITH_9B_TRAIN = 15
ARITH_CROP_9B = (320, 180)             # the plain arithmetic walk's centre crop of a view
# phase 9g: phase 9's views as PNM, TGA, QOI, SGI and PCX files, (row, views) in turn
RAW_9G = (("ppm_p6", 3), ("ppm_p3_ascii", 1), ("pgm_p5_16bit_b19", 1),
          ("tga_raw24_bottom_up", 2), ("tga_rle32_top_left_8alpha", 2),
          ("tga_rle_colormapped_b15", 2), ("tga_raw32_0alpha_b20", 1), ("qoi_rgb", 4),
          ("qoi_rgba", 1), ("sgi_rle8", 2), ("sgi_verbatim16", 1), ("pcx_8x3", 2),
          ("pcx_8x1_palette_b15", 2))
# phase 9i: phase 9's views in DIB, ICO, CUR and DCX containers, (row, views) in turn
CONTAINERS_9I = (("dib_24bit", 3), ("dib_32bit_bitfields_rgba", 2), ("ico_png_0x0_rgb", 3),
                 ("ico_png_0x0_rgba", 2), ("ico_bmp_32bit", 2), ("ico_bmp_24bit_and_mask", 3),
                 ("ico_bmp_8bit_b15", 2), ("ico_bmp_32bit_zero_alpha_b23", 2),
                 ("cur_24bit", 3), ("dcx_two_8x3_pages", 2))
# phase 9j: phase 9's views as SUN, MSP, XBM, XPM and PSD files, (row, views) in turn
RLE_TEXT_9J = (("sun_raw24_bgr", 3), ("sun_rle24_bgr", 3), ("sun_rle8_colormap_b15", 2),
               ("msp_v1_b16", 2), ("msp_v2_rle_b16", 2), ("xbm_b16", 2),
               ("xpm_palette_256_b15", 3), ("xpm_rgb_2cpp", 2), ("psd_raw_rgb", 2),
               ("psd_packbits_rgb", 2), ("psd_packbits_cmyk_b14", 1))
LEVELS_XPM_RGB = (20, 20, 20)          # 8,000 colours: RGB to PIL, 2 characters a pixel
# phase 9k: phase 9's views as FLI, IPTC, IM, IMT and GBR files, (row, views) in turn
RAW_SAMPLE_9K = (("fli_brun_256_b15", 2), ("flc_copy_64_b15", 2), ("iptc_raw_gray", 2),
                 ("iptc_jpeg_gray", 2), ("im_rgb", 2), ("im_lut_b15", 2), ("im_ycc_b30", 2),
                 ("im_l16_b7", 2), ("im_cmyk_b14", 2), ("imt_gray", 2), ("gbr_v1_gray", 2),
                 ("gbr_v2_rgba", 2))
# phase 9l: phase 9's views as PIXAR, McIdas, FITS, FTEX and XV thumbnail files, (row,
# views) in turn (9h takes views 7, 13 and 19: a row of B7, B32 and B15 each)
SAMPLE_TEXTURE_9L = (("pixar_rgb", 3), ("mcidas_1byte", 2), ("fits_8bit", 2),
                     ("mcidas_2byte_b7", 2), ("fits_gzip8", 3), ("fits_16bit_unsigned_b32", 2),
                     ("ftex_dxt1", 3), ("xvthumb_b15", 3), ("ftex_raw", 4))
# phase 9m: phase 9's views as DDS and BLP textures, (row, views) in turn (9h takes views
# 11, 13 and 18: BC5 and BC6H unsigned and signed, none with an alpha)
TEXTURE_9M = (("dds_dxt1_rgba", 3), ("dds_dxt5_ellipse_alpha", 3), ("dds_dx10_bc7_mode6", 3),
              ("dds_bc4_luma", 2), ("dds_bc5_rg", 2), ("dds_dx10_bc6h_uf16", 1),
              ("dds_rgb565_masks", 2), ("blp1_jpeg_bgr", 2), ("dds_dx10_bc6h_sf16", 1),
              ("blp2_dxt1_alpha0", 2), ("blp2_palette_256", 3))
# the reader phases' shared training: view i of phase 9's scene from the file the phase
# `reader_phase(i)` wrote for it
READER_PHASES = ("9b", "9c", "9d", "9f", "9g", "9i", "9j", "9k", "9l", "9m")
READER_9M = (11, 13, 18)               # 9m's views: one each of 9k's, 9l's and 9f's before 9m

# phase 10: serve and shard
ACAP_CALLS = 5
RS_F32_FLOOR = 5e-3    # float32 card path vs the float64 extractor at level 7
RIGID_F32_BAR = 2e-3   # R vs Q on a rigid frame made in float32
VIEWER_FRAMES = 8
E2E_TIMEOUT_S = 600
E2E_ITERATIONS = 10    # the end-to-end script's training (the script's default is 400)
SHARD_WORLD = (2, 2)   # (data, tile) ranks sharing the one card over gloo
SHARD_STEPS = 16       # 8 with the events, 8 free ones whose loss must fall
SHARD_LR_SCALE = 4.4   # phase 6's spatial_lr_scale
SHARD_GROUP_TIMEOUT_S = 300
SHARD_JOIN_S = 900
# phase 10g: the Gaussian-table shard, 4 ranks on the card over gloo
GSHARD_WORLD = 4
GSHARD_STEPS = 8       # a reset at 2, densifies at 3 and 6, a reset at 6
GSHARD_MORE = 1        # steps after the checkpoint: uninterrupted, then resumed
GSHARD_HOT = 2000      # each densify's threshold: the 2,000th largest grads_avg
EXCHANGE_REPS = 1      # the exchange alone, timed this many times (a reported figure)
EMULATED_CALLS = 5

# phase 11: the config-2 quality protocol (tools/quality_run_torch.py)
QUALITY_SEEDS = (0, 1, 2)
QUALITY_BAR_DB = 1.0   # each seed's SMALL test PSNR against the JAX package's
QUALITY_STEP_VIEWS = 4

TOOL_REPS = 2          # phase 12: calls a row of profile_raster_torch.py --prefix
TOOL_FRAMES = 8        # phase 12: bench_playback_torch.py's frames and config-4 steps
TOOL_STEPS4 = 5
SCALING_D = (1, 8)     # phase 13: tools/bench_scaling_torch.py's --d_list
SCALING_STEPS = 3      # phase 13: timed steps of each item of both scaling tools
BENCH_PAIRS = 765_920  # the bench scene's live pairs (bench_torch.py, 1080p, 100,000 Gaussians)
# the multi-rank bars of PERF.md section 2: loss 1e-4 relative, parameters
# 5e-4 of each leaf's largest; gradients the port's 2e-4 of each leaf's largest
RANK_LOSS_REL, RANK_PARAM_REL, RANK_GRAD_REL = 1e-4, 5e-4, 2e-4

# H100 SXM peaks (NVIDIA data sheet; the CUDA programming guide's throughput
# table for the special-function unit: 16 exp2 results / clock / SM) at the
# 700 W limit; a card set below it is slower under load
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
PEAK_MUFU_S = 132 * 16 * 1.98e9

# K1 tolerances against its plain version (the same operation order, so
# they should agree to rounding; these are the acceptance bars)
MAX_ABS, MEAN_ABS, SHARE_OFF, NCONTRIB_EQ = 4e-3, 1e-5, 1e-4, 0.999
# K2 rows: max |kernel - plain| over each column's largest |row| (the same
# per-pixel chain, the 256-pixel sum in another order); K3 against a
# float64 index_add_: max |diff| over each column's largest |sum|
K2_REL, K3_REL = 1e-5, 1e-6


def log(*a):
    print(*a, flush=True)


class Laps:
    """A phase's sub-steps timed on the host clock: each call logs
    `[<tag>-s] <step> <s>` since the call before (or the start)."""

    def __init__(self, tag):
        self.tag, self.t = tag, time.perf_counter()

    def __call__(self, step):
        now = time.perf_counter()
        log(f"[{self.tag}-s] {step} {now - self.t:.1f}")
        self.t = now


def icosphere(subdiv: int):
    """Icosahedron refined `subdiv` times (1:4 midpoint splits), vectorized."""
    t = (1.0 + math.sqrt(5.0)) / 2.0
    v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                  [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                  [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                  [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                  [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                  [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
                 np.int64)
    for _ in range(subdiv):
        e = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]), 1)
        keys, inv = np.unique(e[:, 0] * len(v) + e[:, 1], return_inverse=True)
        mid = v[keys // len(v)] + v[keys % len(v)]
        mid /= np.linalg.norm(mid, axis=1, keepdims=True)
        ab, bc, ca = (len(v) + inv.reshape(3, -1))
        a, b, c = f.T
        f = np.stack([np.stack([a, ab, ca], 1), np.stack([b, bc, ab], 1),
                      np.stack([c, ca, bc], 1), np.stack([ab, bc, ca], 1)],
                     1).reshape(-1, 3)
        v = np.concatenate([v, mid])
    return v.astype(np.float32), f.astype(np.int32)


def orbit_camera(graphics, azimuth, device, distance=4.0, elevation=0.3,
                 width=WIDTH, height=HEIGHT):
    fovx = math.radians(60.0)
    fovy = graphics.focal2fov(graphics.fov2focal(fovx, width), height)
    pos = distance * np.array([math.cos(elevation) * math.sin(azimuth),
                               math.sin(elevation),
                               math.cos(elevation) * math.cos(azimuth)])
    fwd = -pos / np.linalg.norm(pos)
    right = np.cross([0.0, 1.0, 0.0], fwd)
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd], axis=1)
    V = graphics.world_to_view(R, -R.T @ pos)
    P = graphics.projection_matrix(0.01, 100.0, fovx, fovy)
    return graphics.CameraArrays.from_numpy(V, P @ V, pos, math.tan(fovx / 2),
                                            math.tan(fovy / 2), device=device)


def reset_launches(port):
    for fn in (port.tile_blend.blend_forward, port.tile_blend.blend_backward,
               port.segsum.segment_sum):
        fn.launches = 0


def read_launches(port):
    return {"K1": port.tile_blend.blend_forward.launches,
            "K2": port.tile_blend.blend_backward.launches,
            "K3": port.segsum.segment_sum.launches}


def cuda_ms(torch, fn, n, warm=3):
    """Mean device ms of fn() over n launches, after `warm` warm ones."""
    for _ in range(warm):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def cuda_call(torch, fn):
    """One call fn() -> (its result, its device ms), the card idle before it."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def queued_ms(torch, fn, n):
    """As cuda_ms, but the card first sleeps long enough for the host to
    queue the n calls: the kernels' own time, where `cuda_ms` of a call
    whose host path is as long as its kernels reads the host's pace."""
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def host_ms(torch, fn, n):
    """Mean host ms to issue fn() (its wrapper's Python and launch calls),
    over n calls issued while the card sleeps, so none waits on it."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    return ms


def walk_counts(torch, tile_blend, feat, sorted_gid, starts, counts, grid_x,
                width, height):
    """(pair, pixel) work of the sequential walk on this data: K1's
    evaluations (each pixel evaluates its tile's pairs up to and including
    the one that ends it, T * (1 - alpha) < 1e-4, all of them if none does;
    pixels outside the image need none) and the blended (pair, pixel)
    events among them. K2 evaluates each pixel's pairs before its last
    blended one: the sum of n_contrib."""
    # pairs past the largest tile's count are padding: they count nothing
    lists = tile_blend.tile_id_lists(sorted_gid, starts, counts,
                                     feat.shape[0] - 1)[:, :int(counts.max())]
    tf = feat[lists]                                          # (T, K, FEAT)
    num_tiles = tf.shape[0]
    px, py = tile_blend._pixel_coords(torch.arange(num_tiles, device=feat.device),
                                      grid_x)
    done = (px >= width) | (py >= height)
    T = torch.ones_like(px)
    evals = torch.zeros_like(px, dtype=torch.int64)
    blended = torch.zeros_like(evals)
    counts = counts.long()[:, None]
    for j in range(tf.shape[1]):
        live = ~done & (j < counts)
        evals += live
        alpha = tile_blend._alphas(tf[:, j], px, py)
        test_t = T * (1.0 - alpha)
        fire = live & (alpha > 0.0)
        term = fire & (test_t < tile_blend.T_EPS)
        blended += fire & ~term
        T = torch.where(fire & ~term, test_t, T)
        done = done | term
    return int(evals.sum()), int(blended.sum())


def reaches_rows(torch, f, y0, y1):
    """csrc/blend_common.cuh::reaches_rows in PyTorch, for counting: can
    the pairs f (T, FEAT) pass the gate on rows [y0, y1] ((T, W) each)?"""
    ca, cb, cc, op = (f[:, i, None] for i in (2, 3, 4, 5))
    det = ca * cc - cb * cb
    m = torch.maximum(ca, cc)
    well = (ca > 0) & (cc > 0) & (det > 2e-4 * m * m)
    qmax = 1.05 * 2.0 * torch.log(255.0 * op) + 0.5
    reach = torch.sqrt(qmax * ca / det) + 0.5
    y = f[:, 1, None]
    inside = ~((y + reach < y0) | (y - reach > y1))
    return ~(op < 1.0 / 255.0) & (~well | inside)


def k2_walk_counts(torch, tile_blend, k2_args, warps):
    """(pair, warp) work of K2's walk on this data, plain PyTorch, for a
    block of `warps` warps of 16 / warps pixel rows each:
    pair_warp_walked_tile_bound, the iterations if every warp walked every
    pair up to its tile's largest n_contrib; pair_warp_walked, those K2
    walks (each warp the pairs below its own pixels' largest n_contrib that
    can reach its rows); pair_warp_reductions, (pair, warp) with a blended
    lane, each summed over the warp."""
    feat, sorted_gid, starts, counts, final_t, n_contrib, _, _ = k2_args
    gx = -(-final_t.shape[1] // tile_blend.TILE)
    last = tile_blend._tile_blocks(n_contrib[None], gx)[:, 0]       # (T, 256)
    nt = last.shape[0]
    walk = last.amax(1)
    kmax = int(walk.max()) if nt else 0
    lists = tile_blend.tile_id_lists(sorted_gid, starts, counts,
                                     feat.shape[0] - 1)[:, :kmax]
    tiles = torch.arange(nt, device=feat.device)
    px, py = tile_blend._pixel_coords(tiles, gx)
    wlast = last.view(nt, warps, -1).amax(2)
    rows = tile_blend.TILE // warps
    y0 = ((tiles // gx) * tile_blend.TILE)[:, None] + rows * torch.arange(
        warps, device=feat.device)[None, :]
    y0 = y0.to(torch.float32)
    walked, red = (torch.zeros((), dtype=torch.int64, device=feat.device)
                   for _ in range(2))
    for j in range(kmax):
        f = feat[lists[:, j]]
        bl = (j < last) & (tile_blend._alphas(f, px, py) > 0)
        red += bl.view(nt, warps, -1).any(2).sum()
        walked += ((j < wlast) & reaches_rows(torch, f, y0, y0 + rows - 1)).sum()
    return dict(pair_warp_walked_tile_bound=int(walk.sum()) * warps,
                pair_warp_walked=int(walked), pair_warp_reductions=int(red))


def phase_card(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's render and "
                         "training paths run on the card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)}; devices {torch.cuda.device_count()}")
    import gaussianmesh_tpu_torch  # noqa: F401  (sets both TF32 switches)
    assert torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmuls on"
    assert torch.backends.cudnn.allow_tf32 is False, "TF32 convolutions on"
    return smi


def phase_build(_cuda):
    t0 = time.perf_counter()
    logs = _cuda.build()
    log(f"[build] {len(logs)} kernel libraries in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "ptxas" in line and ("registers" in line or "bytes" in line):
                log(f"[build] {name}: {line.strip()}")
    for name in _cuda.KERNELS:
        shape = _cuda.occupancy(name)
        log(f"[build] {name}: {shape['threads']} threads, {shape['smem_bytes']} B "
            f"shared memory per block, {shape['blocks_per_sm']} blocks per SM")
    for name in _cuda.HOST_LIBRARIES:
        t0 = time.perf_counter()
        _cuda.host_library(name)
        log(f"[build] host library {name} (g++) in {time.perf_counter() - t0:.1f} s")


def host_cpu() -> str:
    """The host's CPU as /proc/cpuinfo gives its first processor (model
    name, vendor, family, model number, MHz; a virtual machine may hide the
    name) and the logical core count: the host codecs' figures are this
    CPU's."""
    info = {}
    with contextlib.suppress(OSError), open("/proc/cpuinfo") as fh:
        for line in fh:
            if not line.strip():
                break
            key, _, value = line.partition(":")
            info[key.strip()] = value.strip()
    fields = [info.get("model name", "model name not given"),
              *(f"{k} {info[k]}" for k in ("vendor_id", "cpu family", "model", "cpu MHz")
                if k in info)]
    return f"{', '.join(fields)}, {os.cpu_count()} cores"


def phase_oracle(torch, port):
    """Small scene: rasterize on the card == the sequential oracle."""
    dev = "cuda"
    rng = np.random.default_rng(SEED + 1)
    n, w = 400, 64
    means = torch.tensor(rng.uniform(-1, 1, (n, 3)), dtype=torch.float32, device=dev)
    cov6 = port.maths.covariance_6(
        torch.tensor(rng.uniform(0.02, 0.12, (n, 3)), dtype=torch.float32, device=dev),
        port.maths.normalize(torch.tensor(rng.normal(size=(n, 4)), dtype=torch.float32,
                                          device=dev)))
    op = torch.tensor(rng.uniform(0.2, 0.95, n), dtype=torch.float32, device=dev)
    rgb = torch.tensor(rng.uniform(0.05, 0.95, (n, 3)), dtype=torch.float32, device=dev)
    bg = torch.tensor([0.15, 0.25, 0.35], device=dev)
    fovx = math.radians(60.0)
    g = port.graphics
    pos = np.array([4 * math.sin(0.3), 0.8, 4 * math.cos(0.3)])
    fwd = -pos / np.linalg.norm(pos)
    right = np.cross([0.0, 1.0, 0.0], fwd)
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd], axis=1)
    V = g.world_to_view(R, -R.T @ pos)
    cam = g.CameraArrays.from_numpy(V, g.projection_matrix(0.01, 100.0, fovx, fovx) @ V,
                                    pos, math.tan(fovx / 2), math.tan(fovx / 2), dev)
    out = port.rasterize.rasterize(means, cov6, op, rgb, bg, cam,
                                   port.rasterize.RasterizerConfig(w, w, max_per_tile=256))
    ref = port.oracle.render_sequential(means, cov6, op, rgb, cam, w, w, bg)
    err = (out.color - ref.color).abs().max().item()
    log(f"[oracle] {w}px / {n} Gaussians: max |rasterize - render_sequential| "
        f"= {err:.3g} (tolerance 3e-5)")
    assert err <= 3e-5, err


def make_model(torch, port, tmpdir, subdiv=SUBDIV, device="cuda"):
    v, f = icosphere(subdiv)
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED)
    model = port.mesh_gaussians.create_from_mesh(v, f, max_sh_degree=SH_DEGREE,
                                                 device=device, generator=gen)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    log(f"[slice] create_from_mesh: {f.shape[0]} faces -> {model.bc.shape[0]} "
        f"Gaussians in {time.perf_counter() - t0:.1f} s")
    # perturb to look trained: moved along the faces and off them, resized,
    # turned, mostly opaque, view-dependent color
    rng = np.random.default_rng(SEED)
    n = f.shape[0]
    k = (SH_DEGREE + 1) ** 2 - 1

    def add(param, noise):
        with torch.no_grad():
            param.add_(torch.tensor(noise.astype(np.float32), device=device))

    add(model.bc, rng.normal(0, 0.5, (n, 3)))
    add(model.distance, rng.normal(0, 0.5, (n, 1)))
    add(model.scaling, rng.normal(0, 0.3, (n, 3)))
    add(model.rotation, rng.normal(0, 0.5, (n, 4)))
    add(model.opacity, rng.normal(4.2, 1.5, (n, 1)))
    add(model.features_dc, rng.normal(0, 0.3, (n, 1, 3)))
    add(model.features_rest, rng.normal(0, 0.05, (n, k, 3)))
    path = os.path.join(tmpdir, "point_cloud.ply")
    port.gaussian_ply.save_mesh_gaussian_ply(path, model)
    loaded, _ = port.gaussian_ply.load_mesh_gaussian_ply(path, device=device)
    log(f"[slice] PLY round trip: {os.path.getsize(path) / 1e6:.1f} MB, "
        f"{loaded.bc.shape[0]} Gaussians, SH degree {SH_DEGREE}")
    for name, p in model.named_parameters():
        assert torch.equal(p, getattr(loaded, name)), name
    return loaded


def size_capacities(torch, port, model, cams, width, height, sh_degree,
                    label, arrays=None):
    """max_per_tile and the pair capacities large enough that no view of
    this model (or of the Gaussians `arrays(cam)` gives) overflows, from
    1024 and the defaults up; and each view's largest per-tile pair count."""
    cfg = port.rasterize.RasterizerConfig(width, height, max_per_tile=1024)
    gx, gy = cfg.grid
    arrays = arrays or (lambda cam: port.render.mesh_model_arrays(model, cam,
                                                                  sh_degree))
    while True:
        largest, rect_over = [], 0
        for cam in cams:
            a = arrays(cam)
            n = a.xyz.shape[0]
            prep = port.preprocess.preprocess(a.xyz, a.cov6, cam, width, height,
                                              opacity=a.opacity)
            prep = prep._replace(valid=prep.valid & a.active)
            tiles = port.binning.build_tile_lists(
                prep, gx, gy, 1 << 30, cfg.expand_capacity(n), opacity=a.opacity,
                row_capacity=cfg.row_capacity(n), with_grouped_pos=False)
            largest.append(int(tiles.counts.max()))
            rect_over += int(tiles.rect_overflow)
        if rect_over == 0:
            break
        log(f"[{label}] rect_overflow {rect_over}: doubling the pair capacities")
        cfg = port.rasterize.RasterizerConfig(
            width, height, cfg.max_per_tile, 2 * cfg.pair_capacity_per_gaussian,
            2 * cfg.row_capacity_per_gaussian)
    mpt = cfg.max_per_tile
    while mpt < max(largest):
        mpt *= 2
    if mpt != cfg.max_per_tile:
        log(f"[{label}] largest tile holds {max(largest)} pairs: max_per_tile "
            f"{cfg.max_per_tile} -> {mpt}")
    return port.rasterize.RasterizerConfig(
        width, height, mpt, cfg.pair_capacity_per_gaussian,
        cfg.row_capacity_per_gaussian), largest


def phase_profile(torch, run, n, unit, label):
    """Device time by kernel over n calls of run() (torch.profiler): the 15
    largest and the port's own kernels; and the share of the profiled wall
    time in which the device was idle."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            run(i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    rows = []
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", 0)
            rows.append((us / 1e3 / n, e.count / n, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"[{label}] {n} {unit}s under torch.profiler: wall {wall:.3f} ms/{unit}, "
        f"device busy {busy:.3f} ms/{unit}, idle share {1 - busy / wall:.3f}")
    log(f"[{label}] {sum(r[1] for r in rows):g} device operations (kernels, "
        f"copies, fills) per {unit}")
    for i, (ms, count, name) in enumerate(rows):    # the port's kernels too
        if i < 15 or "segment_sum" in name or "tile_blend" in name:
            log(f"[{label}] {ms:8.3f} ms/{unit} x{count:g} {name[:100]}")
    return dict(wall_ms=wall, busy_ms=busy, idle_share=1 - busy / wall,
                launches=sum(r[1] for r in rows))


def phase_slice(torch, port, tmpdir):
    model = make_model(torch, port, tmpdir)
    cams = [orbit_camera(port.graphics, 2 * math.pi * i / N_VIEWS, "cuda")
            for i in range(N_VIEWS)]
    bg = torch.ones(3, device="cuda")
    with torch.no_grad():
        cfg, largest = size_capacities(torch, port, model, cams, WIDTH, HEIGHT,
                                       SH_DEGREE, "slice")
        log(f"[slice] config: max_per_tile {cfg.max_per_tile}, pair capacity "
            f"{cfg.pair_capacity_per_gaussian}/Gaussian, row capacity "
            f"{cfg.row_capacity_per_gaussian}/Gaussian")

        def frame(cam):
            a = port.render.mesh_model_arrays(model, cam, SH_DEGREE)
            return port.render.render(a, cam, cfg, bg)

        frame(cams[0])                                   # warm frame
        torch.cuda.synchronize()
        reset_launches(port)                             # main path starts
        frames, outs = [], []
        for i, cam in enumerate(cams):
            t0 = time.perf_counter()
            out = frame(cam)
            torch.cuda.synchronize()
            frames.append((time.perf_counter() - t0) * 1e3)
            outs.append(out)
        launches = read_launches(port)                   # main path ends
        phase_profile(torch, lambda i: frame(cams[i]), 3, "frame", "profile")
    for i, out in enumerate(outs):
        covered = (out.final_t < 0.5).float().mean().item()
        log(f"[slice] view {i}: {frames[i]:.2f} ms, num_rendered "
            f"{int(out.num_rendered)}, largest tile {largest[i]}, "
            f"tile/rect/pair overflow "
            f"{int(out.tile_overflow)}/{int(out.rect_overflow)}/"
            f"{int(out.pair_overflow)}, covered {covered:.3f}")
        assert out.color.shape == (3, HEIGHT, WIDTH)
        assert torch.isfinite(out.color).all() and torch.isfinite(out.final_t).all()
        assert int(out.tile_overflow) == 0 and int(out.rect_overflow) == 0
        assert covered >= 0.05, covered
    log(f"[slice] 1080p frame ms: mean {np.mean(frames):.2f}, median "
        f"{np.median(frames):.2f}, all {[round(x, 2) for x in frames]}")
    assert launches == {"K1": N_VIEWS, "K2": 0, "K3": 0}, launches
    return model, cams[0], cfg, launches["K1"], frames


def bound(bytes_, fp32_ops=0, mufu_ops=0):
    bytes_ms = bytes_ / PEAK_BYTES_S * 1e3
    ops_ms = max(fp32_ops / PEAK_FP32_S, mufu_ops / PEAK_MUFU_S) * 1e3
    return dict(bytes=bytes_, bytes_ms=bytes_ms, ops_ms=ops_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def check_k1(torch, tb, args, mpt=None):
    """K1 against its plain version on K1's arguments (feat, sorted_gid,
    starts, counts, grid_x, width, height): errors, times, bound."""
    feat, sorted_gid, starts, counts, gx, width, height = args
    kc, kt, kn = tb.blend_forward(*args)
    (pc, pt, pn), plain_ms = cuda_call(torch, lambda: tb.blend_forward_plain(*args))
    dc = (kc - pc).abs()
    dt = (kt - pt).abs()
    r = dict(
        max_per_tile=mpt, pairs=int(counts.sum()), table_rows=feat.shape[0],
        largest_tile=int(counts.max()),
        max_abs=max(dc.max().item(), dt.max().item()),
        color_max_abs=dc.max().item(), color_mean_abs=dc.mean().item(),
        final_t_max_abs=dt.max().item(), final_t_mean_abs=dt.mean().item(),
        share_off=(dc.amax(0) > 1e-4).float().mean().item(),
        n_contrib_equal=(kn == pn).float().mean().item())
    r["ms"] = cuda_ms(torch, lambda: tb.blend_forward(*args), TIMED_LAUNCHES)
    r["plain_ms"] = plain_ms
    evals, blended = walk_counts(torch, tb, feat, sorted_gid, starts, counts,
                                 gx, width, height)
    r.update(evaluations=evals, blended=blended, **bound(
        r["pairs"] * (4 + 36) + 8 * counts.shape[0] + 20 * width * height,
        fp32_ops=evals * 12, mufu_ops=evals))
    assert r["color_max_abs"] <= MAX_ABS and r["final_t_max_abs"] <= MAX_ABS, r
    assert r["color_mean_abs"] <= MEAN_ABS, r
    assert r["share_off"] <= SHARE_OFF, r
    assert r["n_contrib_equal"] >= NCONTRIB_EQ, r
    return r, kt, kn, blended


def segment_stats(torch, seg, seg_starts):
    """Segment-length statistics of one K3 shape: max, p99, mean, share of
    zero-length segments and count of segments a whole block of the kernel
    sums (more than `segsum.LONG_SEGMENT` rows)."""
    lengths = (seg_starts[1:] - seg_starts[:-1]).double()
    return dict(seg_len_max=int(lengths.max()),
                seg_len_p99=torch.quantile(lengths, 0.99).item(),
                seg_len_mean=lengths.mean().item(),
                seg_zero_share=(lengths == 0).double().mean().item(),
                seg_long=int((lengths > seg.LONG_SEGMENT).sum()))


def check_k3(torch, seg, rows, grouped_pos, seg_starts, again=None):
    """K3 against its plain version (a float64 index_add_) and bit-identical
    over two runs (`again()` gives the second result; by default K3 on the
    same rows again), timed beside the plain version and
    `torch.segment_reduce` with its row gather, bounded by bytes (the rows
    `grouped_pos` names, once each), with the segment-length statistics of
    the shape. `rows` may be any table (`segment_sum_rows`)."""
    d_feat = seg.segment_sum_rows(rows, grouped_pos, seg_starts)
    second = (again or (lambda: seg.segment_sum_rows(rows, grouped_pos,
                                                     seg_starts)))()
    ref64 = seg.segment_sum_plain(rows, grouped_pos, seg_starts)
    torch.cuda.synchronize()
    m, n = grouped_pos.shape[0], seg_starts.shape[0] - 1
    d3 = (d_feat - ref64).abs()
    k3 = dict(gaussians=n, pairs=m, max_abs=d3.max().item(),
              rel=(d3 / ref64.abs().amax(0).clamp(min=1e-30)).max().item(),
              bit_identical=bool(torch.equal(d_feat, second)),
              **segment_stats(torch, seg, seg_starts))
    lengths = (seg_starts[1:] - seg_starts[:-1]).long()
    call = lambda: seg.segment_sum_rows(rows, grouped_pos, seg_starts)  # noqa: E731
    k3["ms"] = cuda_ms(torch, call, TIMED_LAUNCHES)
    k3["queued_ms"] = queued_ms(torch, call, TIMED_LAUNCHES)
    k3["host_ms"] = host_ms(torch, call, TIMED_LAUNCHES)
    k3["plain_ms"] = cuda_ms(torch, lambda: seg.segment_sum_plain(
        rows, grouped_pos, seg_starts), TIMED_LAUNCHES)
    k3["library_ms"] = cuda_ms(torch, lambda: torch.segment_reduce(
        rows[grouped_pos.long()], "sum", lengths=lengths), TIMED_LAUNCHES)
    k3.update(**bound(m * (64 + 4) + (n + 1) * (4 + 64)))
    assert k3["rel"] <= K3_REL and k3["bit_identical"], k3
    return k3


def fullscreen_case(torch, seg, gid_counts, tiles_total, seed):
    """K3's inputs with 8 full-screen splats: the given per-Gaussian pair
    counts with Gaussians 0, N - 1 and six spread between set to
    `tiles_total` pairs (one per tile of the image); rows N(0, 1) and
    `grouped_pos` a permutation of the M pairs, both from `seed`.
    -> rows, grouped_pos, seg_starts."""
    counts = gid_counts.to(torch.int64)
    n = counts.shape[0]
    ids = torch.linspace(0, n - 1, 8, device=counts.device).round().long()
    counts[ids] = tiles_total
    seg_starts = seg.segment_starts(counts)
    m = int(seg_starts[-1])
    gen = torch.Generator(device=counts.device).manual_seed(seed)
    rows = torch.randn((m, seg.FEAT), generator=gen, device=counts.device)
    grouped_pos = torch.randperm(m, generator=gen, device=counts.device)
    return rows, grouped_pos.to(torch.int32), seg_starts


def check_k2_k3(torch, port, k2_args, grouped_pos, seg_starts, blended,
                step_rows=None, warp_walk=False):
    """K2 on its arguments (feat, sorted_gid, starts, counts, final_t,
    n_contrib, g_color, g_final_t) and K3 on K2's rows: against their plain
    versions, bit-identical over two runs (and to the rows a training step
    produced, where given), timed, bounded by this data's work; with
    `warp_walk`, K2's (pair, warp) walk counts too (`k2_walk_counts`: a
    figure of K2's design that no check or bound reads, taken at the
    slice's shapes in phase 5)."""
    tb, seg = port.tile_blend, port.segsum
    feat, _, starts, counts, final_t, n_contrib, _, _ = k2_args
    height, width = final_t.shape
    gx = -(-width // tb.TILE)
    rows = tb.blend_backward(*k2_args)
    plain_rows, plain_ms = cuda_call(torch, lambda: tb.blend_backward_plain(*k2_args))
    k3 = check_k3(torch, seg, rows, grouped_pos, seg_starts,
                  again=lambda: seg.segment_sum(tb.blend_backward(*k2_args),
                                                grouped_pos, seg_starts))
    m = rows.shape[0]
    d2 = (rows - plain_rows).abs()
    k2 = dict(pairs=m, table_rows=feat.shape[0],
              rows_nonzero=int((rows != 0).any(1).sum()),
              max_abs=d2.max().item(),
              rel=(d2 / plain_rows.abs().amax(0).clamp(min=1e-30)).max().item(),
              zero_rows_equal=bool(torch.equal(rows == 0, plain_rows == 0)))
    if step_rows is not None:
        k2["same_as_step"] = bool(torch.equal(rows, step_rows))
    k2["ms"] = cuda_ms(torch, lambda: tb.blend_backward(*k2_args), TIMED_LAUNCHES)
    k2["plain_ms"] = plain_ms
    # each tile stages (gid + 9 feature floats) only for pairs [0, walk),
    # walk its pixels' largest n_contrib; rows past it are written as zeros
    staged = int(tb._tile_blocks(n_contrib[None], gx)[:, 0].amax(1).sum())
    evals = int(n_contrib.sum())      # pairs each pixel walks back over
    if warp_walk:
        k2.update(k2_walk_counts(torch, tb, k2_args,
                                 port._cuda.occupancy("tile_blend_bwd")["threads"] // 32))
    k2.update(evaluations=evals, blended=blended, staged_pairs=staged, **bound(
        staged * (4 + 36) + 4 * (counts.shape[0] + 1)
        + 24 * width * height + 64 * m,
        fp32_ops=evals * 12 + blended * 40, mufu_ops=evals + 2 * blended))
    assert k2["rel"] <= K2_REL and k2["zero_rows_equal"], k2
    assert k2.get("same_as_step", True), k2
    assert k2["rows_nonzero"] > 0
    return k2, k3


def phase_kernels(torch, port, model, cam, cfg):
    """K1, then K2 and K3 with seeded cotangents, against their plain
    versions on view 0's binned pair domain, at the slice's max_per_tile and
    clamped to 64; then K3 on the full-screen case built from view 0's pair
    counts. -> ({"slice" | "clamped": (k1, k2, k3)}, full-screen k3)"""
    tb = port.tile_blend
    gx, gy = cfg.grid
    n = model.bc.shape[0]
    results = {}
    with torch.no_grad():
        a = port.render.mesh_model_arrays(model, cam, SH_DEGREE)
        prep = port.preprocess.preprocess(a.xyz, a.cov6, cam, WIDTH, HEIGHT,
                                          opacity=a.opacity)
        prep = prep._replace(valid=prep.valid & a.active)
        feat = tb.pack_features(prep.mean2d, prep.conic, a.opacity, a.rgb, prep.valid)
        rng = np.random.default_rng(SEED + 2)
        g_color = torch.tensor(rng.normal(size=(3, HEIGHT, WIDTH)).astype(np.float32),
                               device="cuda")
        g_final_t = torch.tensor(rng.normal(size=(HEIGHT, WIDTH)).astype(np.float32),
                                 device="cuda")
        for label, mpt in (("slice", cfg.max_per_tile), ("clamped", 64)):
            tiles = port.binning.build_tile_lists(
                prep, gx, gy, mpt, cfg.expand_capacity(n), opacity=a.opacity,
                row_capacity=cfg.row_capacity(n))
            assert (int(tiles.tile_overflow) > 0) == (label == "clamped")
            k1, final_t, n_contrib, blended = check_k1(
                torch, tb, (feat, tiles.sorted_gid, tiles.starts, tiles.counts,
                            gx, WIDTH, HEIGHT), mpt)
            log(f"[kernels] K1 {label}: " + json.dumps(k1))
            k2_args = (feat, tiles.sorted_gid, tiles.starts, tiles.counts,
                       final_t, n_contrib, g_color, g_final_t)
            k2, k3 = check_k2_k3(torch, port, k2_args, tiles.grouped_pos,
                                 port.segsum.segment_starts(tiles.gid_counts),
                                 blended, warp_walk=True)
            log(f"[kernels] K2 {label}: " + json.dumps(k2))
            log(f"[kernels] K3 {label}: " + json.dumps(k3))
            results[label] = (k1, k2, k3)
            if label == "slice":
                case = fullscreen_case(torch, port.segsum, tiles.gid_counts,
                                       gx * gy, SEED + 3)
        fullscreen = check_k3(torch, port.segsum, *case)
        log("[kernels] K3 full-screen case: " + json.dumps(fullscreen))
    return results, fullscreen


KERNELS = (
    ("K1", "tile_blend_fwd (K1, blend forward)", "tile_blend_fwd.cu",
     "gaussianmesh_tpu/ops/tile_blend.py:1111"),
    ("K2", "tile_blend_bwd (K2, blend backward)", "tile_blend_bwd.cu",
     "gaussianmesh_tpu/ops/tile_blend.py:1187"),
    ("K3", "segment_sum (K3, per-Gaussian gradient reduction)", "segment_sum.cu",
     "gaussianmesh_tpu/ops/segsum.py:132"),
)


def kernel_line(results, fullscreen, launches):
    """The `kernels` JSON entries: times and bounds at the slice config,
    beside them those at the clamped config, at a mesh training step's and
    a background step's shapes ("pipeline"), at a 1600x900 step's of the
    eval phase ("eval"), at one rank's band of a 2x2 sharded step ("band"),
    at rank 0's received band of a Gaussian-table-sharded step ("gshard"; for
    K3 the receiver's reduction, and the owner's as "gshard_owner"), (K1) at
    a composite playback frame's, at the quality step's ("quality"), at
    `bench_torch.py`'s step ("bench": 1080p, 100,000 Gaussians), at the
    scaling tool's D = 8 critical band ("scaling_band") and critical emulated
    rank ("scaling_gshard"; the owner's K3 "scaling_gshard_owner"), and K3's
    on the full-screen case; errors over all of them; launches from the main
    paths (render, train, playback, pipeline, eval, readers: the reader
    phases' shared training, serve, shard, gshard, quality, tools,
    scaling)."""
    line = []
    for i, (key, name, source, replaces) in enumerate(KERNELS):
        r = {label: res[i] for label, res in results.items() if res[i] is not None}
        if key == "K3":
            r["fullscreen"] = fullscreen
        s = r["slice"]
        err = max(x["max_abs"] for x in r.values())
        entry = {
            "name": name, "route": "cuda",
            "source": f"gaussianmesh_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": sum(n[key] for n in launches.values()),
            **{f"{path}_launches": n[key] for path, n in launches.items()},
            "max_abs_err": err, "max_abs": err,
            "ms": s["ms"], "kernel_ms": s["ms"], "plain_ms": s["plain_ms"],
            "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
            "library_ms": s.get("library_ms"),
        }
        entry.update({k: s[k] for k in ("queued_ms", "host_ms") if k in s})
        if "rel" in s:
            entry["max_rel_err"] = max(x["rel"] for x in r.values())
        for label in ("clamped", "train", "fullscreen", "composite", "pipeline", "eval",
                      "band", "gshard", "gshard_owner", "quality", "bench", "scaling_band",
                      "scaling_gshard", "scaling_gshard_owner"):
            for k in ("ms", "queued_ms", "host_ms", "plain_ms", "bound_ms",
                      "library_ms", "max_abs"):
                if k in r.get(label, {}):
                    entry[f"{label}_{k}"] = r[label][k]
        line.append(entry)
    return line


def capture_step(torch, port, trainer, cam=0):
    """One more training step (`step` of a `MeshTrainer` or a `BgTrainer`,
    on view `cam` over its constant background; a tensor of one view per
    data group for a multi-process `MeshTrainer`) through `capture_calls`."""
    return capture_calls(torch, port, lambda: trainer.step(cam, trainer.bg_const))


def capture_calls(torch, port, run):
    """run() (one forward + backward) with the wrappers of K1, K2 and K3
    (`segment_sum_rows`, which every K3 call goes through) recording the
    arguments it hands them. -> {"K1": args, "K2": args, "K3": args} and,
    for the Gaussian-table shard's second K3 call (the owner's reduction),
    "K3_owner". The launch counters are set back to what they were: this
    call is not the main path's."""
    wrappers = {"K1": (port.tile_blend, "blend_forward"),
                "K2": (port.tile_blend, "blend_backward"),
                "K3": (port.segsum, "segment_sum_rows")}
    calls, kept = {key: [] for key in wrappers}, {}
    counts = read_launches(port)
    for key, (mod, attr) in wrappers.items():
        kept[key] = getattr(mod, attr)

        @functools.wraps(kept[key])
        def record(*args, _fn=kept[key], _key=key):
            calls[_key].append(tuple(a.clone() if torch.is_tensor(a) else a
                                     for a in args))
            return _fn(*args)

        setattr(mod, attr, record)
    try:
        run()
    finally:
        for key, (mod, attr) in wrappers.items():
            setattr(mod, attr, kept[key])
        port.tile_blend.blend_forward.launches = counts["K1"]
        port.tile_blend.blend_backward.launches = counts["K2"]
        port.segsum.segment_sum.launches = counts["K3"]
    assert [len(calls[k]) for k in ("K1", "K2")] == [1, 1], calls.keys()
    assert len(calls["K3"]) in (1, 2), len(calls["K3"])
    seen = {key: c[0] for key, c in calls.items()}
    if len(calls["K3"]) == 2:
        seen["K3_owner"] = calls["K3"][1]
    return seen


def train_dataset(torch, port, model):
    """TRAIN_VIEWS orbit views of the slice model at TRAIN_SIZE^2 over a
    white background, rendered by the port's forward -> DeviceDataset."""
    size = TRAIN_SIZE
    cams = [orbit_camera(port.graphics, 2 * math.pi * i / TRAIN_VIEWS, "cuda",
                         elevation=0.3 + 0.4 * math.sin(i), width=size, height=size)
            for i in range(TRAIN_VIEWS)]
    with torch.no_grad():
        cfg, largest = size_capacities(torch, port, model, cams, size, size,
                                       SH_DEGREE, "train")
        bg = torch.ones(3, device="cuda")
        images = []
        for cam in cams:
            out = port.render.render(port.render.mesh_model_arrays(
                model, cam, SH_DEGREE), cam, cfg, bg)
            assert int(out.tile_overflow) == 0 and int(out.rect_overflow) == 0
            images.append((out.color.clamp(0, 1) * 255).round().to(torch.uint8))
    log(f"[train] ground truth: {TRAIN_VIEWS} views at {size}x{size}, largest "
        f"tile {max(largest)}")
    stack = lambda k: torch.stack([getattr(c, k) for c in cams])  # noqa: E731
    return port.trainer.DeviceDataset(
        view=stack("viewmatrix"), proj=stack("projmatrix"), campos=stack("campos"),
        tanfovx=stack("tanfovx"), tanfovy=stack("tanfovy"),
        images=torch.stack(images), masks=None, width=size, height=size)


def phase_train(torch, port, model):
    """Config-2 training at full width through MeshTrainer.train."""
    ds = train_dataset(torch, port, model)
    v, f = icosphere(PROXY_SUBDIV)
    # shrunk schedule: reset (white background) at 10, densify at 20 and
    # 30, interval reset at 20; iterations 31-60 have no event. The default
    # densify threshold 2e-4 splits nothing this early (grads_avg at
    # iteration 20 on an H100: median 2.1e-5, max 9.1e-5; at 30 max 1.9e-5),
    # so the smoke lowers it to 1e-5.
    opt = port.config.OptimizationParams(
        densify_from_iter=10, densification_interval=10, densify_until_iter=35,
        opacity_reset_interval=20, densify_grad_threshold=1e-5)
    t0 = time.perf_counter()
    trainer = port.trainer.MeshTrainer(
        v, f, ds, opt, port.config.RuntimeParams(), spatial_lr_scale=4.4,
        init_target=INIT_TARGET, max_sh_degree=SH_DEGREE)
    torch.cuda.synchronize()
    n0 = int(trainer.model.alive.sum())
    log(f"[train] MeshTrainer: {f.shape[0]} faces -> {n0} Gaussians after the "
        f"init subdivision (capacity {trainer.model.capacity}) in "
        f"{time.perf_counter() - t0:.1f} s")
    with torch.no_grad():
        cfg, largest = size_capacities(
            torch, port, trainer.model, [ds.camera(i) for i in range(TRAIN_VIEWS)],
            TRAIN_SIZE, TRAIN_SIZE, SH_DEGREE, "train")
    # headroom: scales move while training
    trainer.rt = dataclasses.replace(
        trainer.rt, max_per_tile=2 * cfg.max_per_tile,
        pair_capacity_per_gaussian=2 * cfg.pair_capacity_per_gaussian,
        row_capacity_per_gaussian=2 * cfg.row_capacity_per_gaussian)
    log(f"[train] student's largest tile {max(largest)} pairs; config "
        f"{trainer.rt}")
    trainer.sh_degree = SH_DEGREE   # the state after iteration 3000

    densify = trainer.densify

    def densify_logged():
        g = port.densify.grads_avg(trainer.model.state)[trainer.model.alive]
        q = torch.quantile(g, torch.tensor([0.5, 0.9, 0.99, 0.999], device=g.device))
        log(f"[train] iteration {trainer.global_it}: grads_avg over alive rows: "
            f"median/p90/p99/p99.9 {[f'{x:.3g}' for x in q.tolist()]}, max "
            f"{g.max().item():.3g}, >= threshold "
            f"{int((g >= opt.densify_grad_threshold).sum())}")
        return densify()

    trainer.densify = densify_logged
    psnr0 = trainer.eval_psnr(range(0, TRAIN_VIEWS, 6))

    step_ms, log_rows = [], []
    clock = [0.0]

    def on_step(m):
        torch.cuda.synchronize()
        now = time.perf_counter()
        step_ms.append((now - clock[0]) * 1e3)
        clock[0] = now
        log_rows.append(m)

    torch.cuda.synchronize()
    reset_launches(port)                                 # main path starts
    clock[0] = time.perf_counter()
    trainer.train(TRAIN_ITERS, log_every=1, callback=on_step)
    launches = read_launches(port)                       # main path ends
    phase_profile(torch, lambda i: trainer.train(1, log_every=1000), 3, "step",
                  "train profile")
    psnr1 = trainer.eval_psnr(range(0, TRAIN_VIEWS, 6))

    for it, kind, info in trainer.events:
        log(f"[train] iteration {it}: {kind} {json.dumps(info)}")
    last_event = max(it for it, _, _ in trainer.events)
    free = [i for i, m in enumerate(log_rows) if m["iter"] > last_event]
    free_ms = [step_ms[i] for i in free]
    losses = [log_rows[i]["loss"] for i in free]
    log(f"[train] loss by iteration: "
        f"{[round(m['loss'], 5) for m in log_rows]}")
    log(f"[train] event-free step ms ({len(free)} steps, iterations "
        f"{last_event + 1}-{TRAIN_ITERS}): median {np.median(free_ms):.3f}, "
        f"mean {np.mean(free_ms):.3f}, all {[round(x, 3) for x in free_ms]}")
    log(f"[train] launches over {TRAIN_ITERS} steps: {launches}; n_alive "
        f"{n0} -> {int(trainer.model.alive.sum())}; PSNR (4 views) "
        f"{psnr0:.3f} -> {psnr1:.3f}")

    assert launches == {"K1": TRAIN_ITERS, "K2": TRAIN_ITERS,
                        "K3": TRAIN_ITERS}, launches
    assert all(math.isfinite(m["loss"]) for m in log_rows)
    assert all(m["tile_overflow"] == 0 and m["rect_overflow"] == 0
               for m in log_rows), "overflow while training"
    for name, p in trainer.model.named_parameters():
        assert torch.isfinite(p).all(), name
    kinds = [(it, kind) for it, kind, _ in trainer.events]
    assert kinds == [(10, "opacity_reset"), (20, "densify"), (20, "opacity_reset"),
                     (30, "densify")], kinds
    assert any(info["n_split"] >= 1 for _, kind, info in trainer.events
               if kind == "densify"), "densify split nothing"
    assert len(free) >= 20
    assert np.mean(losses[-10:]) < np.mean(losses[:10]), losses

    # the kernels on the arguments of one more (event-free) step: the
    # step's table (capacity rows, dead ones included), pair domain and
    # cotangents from the real loss
    seen = capture_step(torch, port, trainer)
    k1, _, _, blended = check_k1(torch, port.tile_blend, seen["K1"],
                                 trainer.rt.max_per_tile)
    log("[train] K1 at the step's shapes: " + json.dumps(k1))
    rows, grouped_pos, seg_starts = seen["K3"]
    k2, k3 = check_k2_k3(torch, port, seen["K2"], grouped_pos, seg_starts,
                         blended, step_rows=rows)
    log("[train] K2 at the step's shapes: " + json.dumps(k2))
    log("[train] K3 at the step's shapes: " + json.dumps(k3))
    return launches, free_ms, (k1, k2, k3), trainer


def twist_frames(v, n_frames, amp=TWIST_AMP):
    """tools/bench_playback.py::_twist_frames: a twist about z by
    amp * sin(2 pi i / n) * z, frame i of n."""
    out = []
    for i in range(n_frames):
        a = amp * np.sin(2 * np.pi * i / n_frames)
        ang = a * v[:, 2]
        c, s = np.cos(ang), np.sin(ang)
        out.append(np.stack([c * v[:, 0] - s * v[:, 1],
                             s * v[:, 0] + c * v[:, 1], v[:, 2]], axis=-1))
    return np.stack(out).astype(np.float32)


def rotation(axis, angle):
    axis = np.asarray(axis, float) / np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k


def write_object(torch, port, tmpdir, name, subdiv, offset=(0.0, 0.0, 0.0)):
    """tools/bench_playback.py::_make_object on the port: one Gaussian per
    face of an icosphere, colour by position, opacity logit 4, saved as
    PLY + OBJ -> (PLY path, OBJ path, vertices)."""
    v, f = icosphere(subdiv)
    v = (v + np.asarray(offset, np.float32)).astype(np.float32)
    model = port.mesh_gaussians.create_from_mesh(v, f, max_sh_degree=SH_DEGREE,
                                                 device="cuda")
    with torch.no_grad():
        cent = model.get_xyz()
        lo, hi = cent.amin(0), cent.amax(0)
        model.features_dc.copy_(port.sh.rgb_to_sh((cent - lo) / (hi - lo + 1e-6))[:, None])
        model.opacity.fill_(4.0)
    ply, obj = (os.path.join(tmpdir, f"{name}.{ext}") for ext in ("ply", "obj"))
    port.gaussian_ply.save_mesh_gaussian_ply(ply, model)
    port.mesh_io.write_triangle_mesh(obj, v, f)
    return ply, obj, v


def write_background(port, tmpdir, n, seed):
    """tools/bench_playback.py's background: n vanilla Gaussians at U(-6, 6)
    positions and U(0, 1) colours from `seed`, log-scale ln 0.05, opacity
    0.1, SH degree 1, saved as a PLY."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-6, 6, (n, 3))
    dc = (rng.uniform(0, 1, (n, 3)) - 0.5) / port.sh.C0
    params = dict(xyz=xyz, features_dc=dc[:, None], features_rest=np.zeros((n, 3, 3)),
                  scaling=np.full((n, 3), math.log(0.05)),
                  rotation=np.tile([1.0, 0, 0, 0], (n, 1)),
                  opacity=np.full((n, 1), math.log(0.1 / 0.9)))
    path = os.path.join(tmpdir, "bg.ply")
    port.gaussian_ply.save_gaussian_ply(
        path, port.gaussians.from_numpy(params, np.ones(n, bool), device="cuda"))
    return path


def record_k1(port):
    """A stand-in for K1's wrapper that keeps the arguments of its calls
    (its `launches` its own, as in `capture_step`) -> (stand-in, calls)."""
    import functools

    real, calls = port.tile_blend.blend_forward, []

    @functools.wraps(real)
    def record(*args):
        calls.append(args)
        return real(*args)

    record.launches = 0
    return record, calls


def timed_frames(torch, run, n):
    """Host ms of run(i) ending in synchronize(), i < n -> (times, outputs)."""
    times, outs = [], []
    for i in range(n):
        t0 = time.perf_counter()
        outs.append(run(i))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times, outs


def check_frames(torch, outs, label):
    for i, o in enumerate(outs):
        assert torch.isfinite(o.color).all(), (label, i)
        assert int(o.tile_overflow) == 0 and int(o.rect_overflow) == 0, (label, i, o)


def phase_playback(torch, port, model, cam, cfg, tmpdir):
    """Configs 3 and 5 at 1080p, then the edit command line."""
    rt = port.runtime
    v, f = icosphere(SUBDIV)
    ply = os.path.join(tmpdir, "point_cloud.ply")            # the slice model
    origin = os.path.join(tmpdir, "origin.obj")
    port.mesh_io.write_triangle_mesh(origin, v, f)
    t0 = time.perf_counter()
    obj = rt.ObjectDeformer(ply, origin, device="cuda")
    torch.cuda.synchronize()
    log(f"[playback] ObjectDeformer: {obj.n} Gaussians on {v.shape[0]} vertices, "
        f"{time.perf_counter() - t0:.2f} s (one-ring {obj.deformer.setup_s:.2f} s, "
        f"{obj.deformer.neighbors.shape[1]} slots)")
    frames = torch.tensor(twist_frames(v, PLAYBACK_FRAMES), device="cuda")
    bg = torch.ones(3, device="cuda")
    # headroom: the twist moves splats between tiles
    cfg3 = dataclasses.replace(cfg, max_per_tile=2 * cfg.max_per_tile)
    res = {}

    with torch.no_grad():
        # config 3 checks: the identity frame against the slice's render,
        # a rigid frame against the rigid motion
        ident = rt.make_playback_fn(obj, cam, cfg3, bg)(obj.deformer.v_ref)
        ref = port.render.render(port.render.mesh_model_arrays(model, cam, SH_DEGREE),
                                 cam, cfg3, bg)
        d = (ident.color - ref.color).abs()
        q = rotation([0.3, 1.0, 0.2], 0.7)
        qt, tt = (torch.tensor(x, dtype=torch.float32, device="cuda")
                  for x in (q, [0.5, -0.2, 0.1]))
        pos, cov6, r_hat = obj.transfer(obj.deformer.v_ref @ qt.T + tt)
        want_pos = obj.pos0 + obj.proj0 @ qt.T + tt - obj.proj0
        cov0 = port.maths.unstrip_symmetric(obj.cov6_0)
        want_cov = qt @ cov0 @ qt.T
        cov_err = ((port.maths.unstrip_symmetric(cov6) - want_cov).abs().amax((1, 2))
                   / cov0.abs().amax((1, 2)))
        checks = dict(identity_max_abs=d.max().item(), identity_mean_abs=d.mean().item(),
                      rigid_pos_max_abs=(pos - want_pos).abs().max().item(),
                      rigid_cov_rel=cov_err.max().item(),
                      rigid_r_max_abs=(r_hat - qt).abs().max().item())
        log("[playback] config 3 checks: " + json.dumps(checks))
        assert checks["identity_max_abs"] <= IDENTITY_MAX, checks
        assert checks["identity_mean_abs"] <= IDENTITY_MEAN, checks
        assert checks["rigid_pos_max_abs"] <= RIGID_POS, checks
        assert checks["rigid_cov_rel"] <= RIGID_COV_REL, checks

        # config 3: the frame loop (main path), the deformation alone, a profile
        frame_fn = rt.make_playback_fn(obj, cam, cfg3, bg)
        frame_fn(frames[1])                                  # warm frame
        torch.cuda.synchronize()
        reset_launches(port)                                 # main path starts
        times, outs = timed_frames(torch, lambda i: frame_fn(frames[i]),
                                   PLAYBACK_FRAMES)
        launches3 = read_launches(port)                      # main path ends
        check_frames(torch, outs, "config 3")
        seq = rt.playback_sequence(obj, cam, cfg3, frames[:2], bg)
        assert all(torch.equal(seq.color[i], outs[i].color) for i in range(2))
        del outs, seq
        deform_ms, _ = timed_frames(
            torch, lambda i: rt.deformed_object_arrays(obj, frames[i], cam),
            PLAYBACK_FRAMES)
        prof_d = phase_profile(torch, lambda i: rt.deformed_object_arrays(
            obj, frames[i], cam), 3, "frame", "deformation profile")
        prof = phase_profile(torch, lambda i: frame_fn(frames[i]), 3, "frame",
                             "playback profile")
        res["config3"] = dict(gaussians=obj.n, frames=PLAYBACK_FRAMES,
                              frame_ms_mean=float(np.mean(times)),
                              frame_ms_median=float(np.median(times)),
                              deform_ms_mean=float(np.mean(deform_ms)),
                              deform_ms_median=float(np.median(deform_ms)),
                              deform_device_ms=prof_d["busy_ms"],
                              deform_launches=prof_d["launches"],
                              k1_per_frame=launches3["K1"] / PLAYBACK_FRAMES,
                              device_launches_per_frame=prof["launches"],
                              device_busy_ms=prof["busy_ms"],
                              idle_share=prof["idle_share"], **checks)
        log("[playback] config 3: " + json.dumps(res["config3"]))
        log(f"[playback] config 3 frame ms: {[round(x, 2) for x in times]}")
        assert launches3 == {"K1": PLAYBACK_FRAMES, "K2": 0, "K3": 0}, launches3

        # config 5: the slice object deforming among two static objects
        # and a background
        editor = rt.SceneEditor(bg_ply_path=write_background(port, tmpdir, BG_GAUSSIANS,
                                                             SEED + 5),
                                max_sh_degree=None, device="cuda")
        editor.add_object(ply, origin, name="main")
        for i, off in enumerate(SIDE_OFFSETS):
            p2, o2, _ = write_object(torch, port, tmpdir, f"side{i}", SIDE_SUBDIV, off)
            editor.add_object(p2, o2, name=f"side{i}")
        n_total = editor.arrays(cam).xyz.shape[0]
        assert n_total == CONFIG5_GAUSSIANS, n_total
        # max_per_tile from the whole scene (twice, as config 3's); the
        # static set's pair capacities from its own load (the main object
        # is the first obj.n rows of the scene)
        scene_cfg, largest = size_capacities(torch, port, None, [cam], WIDTH, HEIGHT,
                                             SH_DEGREE, "playback",
                                             arrays=editor.arrays)
        cfg5 = dataclasses.replace(cfg3, max_per_tile=2 * scene_cfg.max_per_tile)
        static_cfg, _ = size_capacities(
            torch, port, None, [cam], WIDTH, HEIGHT, SH_DEGREE, "playback",
            arrays=lambda c: port.render.GaussianArrays(
                *(x[obj.n:] for x in editor.arrays(c))))
        log(f"[playback] config 5: max_per_tile {cfg5.max_per_tile}; static pair / "
            f"row capacity {static_cfg.pair_capacity_per_gaussian} / "
            f"{static_cfg.row_capacity_per_gaussian} per Gaussian")
        t0 = time.perf_counter()
        frame5 = rt.make_composite_playback_fn(editor, "main", cam, cfg5,
                                               static_cfg=static_cfg)
        torch.cuda.synchronize()
        static_ms = (time.perf_counter() - t0) * 1e3
        # frames 0 and 8 (the largest twist) against the editor's render of
        # the same deformed scene; K1's arguments of frame 0 recorded
        record, calls = record_k1(port)
        kept = port.tile_blend.blend_forward
        port.tile_blend.blend_forward = record
        try:
            comp = [frame5(frames[i]) for i in (0, PLAYBACK_FRAMES // 4)]
        finally:
            port.tile_blend.blend_forward = kept
        equal = []
        for i, c in zip((0, PLAYBACK_FRAMES // 4), comp):
            editor.deform_object("main", frames[i])
            r = editor.render(cam, cfg5)
            equal.append((c.color - r.color).abs().max().item())
            assert all(torch.equal(getattr(c, k), getattr(r, k))
                       for k in ("tile_overflow", "rect_overflow", "num_rendered"))
        editor.objects["main"].reset()
        frame5(frames[1])                                    # warm frame
        torch.cuda.synchronize()
        reset_launches(port)                                 # main path starts
        times5, outs5 = timed_frames(torch, lambda i: frame5(frames[i]),
                                     PLAYBACK_FRAMES)
        launches5 = read_launches(port)                      # main path ends
        check_frames(torch, outs5, "config 5")
        num_rendered = int(outs5[0].num_rendered)
        del outs5
        deform5, _ = timed_frames(
            torch, lambda i: rt.deformed_object_arrays(editor.objects["main"],
                                                       frames[i], cam),
            PLAYBACK_FRAMES)
        prof5 = phase_profile(torch, lambda i: frame5(frames[i]), 3, "frame",
                              "composite profile")
        res["config5"] = dict(gaussians=n_total, frames=PLAYBACK_FRAMES,
                              max_per_tile=cfg5.max_per_tile,
                              largest_tile=max(largest), num_rendered=num_rendered,
                              static_precompute_ms=static_ms,
                              frame_ms_mean=float(np.mean(times5)),
                              frame_ms_median=float(np.median(times5)),
                              deform_ms_mean=float(np.mean(deform5)),
                              deform_ms_median=float(np.median(deform5)),
                              k1_per_frame=launches5["K1"] / PLAYBACK_FRAMES,
                              device_launches_per_frame=prof5["launches"],
                              device_busy_ms=prof5["busy_ms"],
                              idle_share=prof5["idle_share"],
                              render_max_abs=equal)
        log("[playback] config 5: " + json.dumps(res["config5"]))
        log(f"[playback] config 5 frame ms: {[round(x, 2) for x in times5]}")
        assert launches5 == {"K1": PLAYBACK_FRAMES, "K2": 0, "K3": 0}, launches5
        assert max(equal) <= COMPOSITE_MAX, equal

        # K1 on frame 0's composite arguments
        assert len(calls) == 2 and record.launches == 2, calls
        k1, _, _, _ = check_k1(torch, port.tile_blend, calls[0], cfg5.max_per_tile)
        log("[playback] K1 at the composite frame's shapes: " + json.dumps(k1))
    res["cli"] = phase_cli(torch, port, tmpdir)
    launches = {k: launches3[k] + launches5[k] for k in launches3}
    return res, k1, launches


def phase_cli(torch, port, tmpdir):
    """`cli.edit.main` on the card: a small model directory (an icosphere-5
    object, one orbit camera at 1920x1080 in cameras.json, cfg_args.json),
    two twisted meshes -> two PNGs, each decoding to the editor's render of
    that mesh, quantised."""
    root = os.path.join(tmpdir, "cli_model")
    os.makedirs(root)
    ply, origin, v = write_object(torch, port, root, "object", CLI_SUBDIV)
    meshes = []
    for i, vd in enumerate(twist_frames(v, 8)[1:3]):
        meshes.append(os.path.join(root, f"frame{i}.obj"))
        port.mesh_io.write_triangle_mesh(meshes[-1], vd, icosphere(CLI_SUBDIV)[1])
    fovx = math.radians(60.0)
    fovy = port.graphics.focal2fov(port.graphics.fov2focal(fovx, WIDTH), HEIGHT)
    cam = port.pose_paths.ellipse_path(1, np.zeros(3), (4 * math.cos(0.3),) * 2,
                                       4 * math.sin(0.3), fovx, fovy, WIDTH, HEIGHT)[0]
    with open(os.path.join(root, "cameras.json"), "w") as fh:
        json.dump([port.cameras.camera_to_json(0, cam)], fh)
    # capacities for the object's splats (~20 pairs each at 1080p)
    rt = port.config.RuntimeParams(max_per_tile=4096, pair_capacity_per_gaussian=32,
                                   row_capacity_per_gaussian=8)
    port.config.save_cfg(root, {"model": port.config.ModelParams(model_path=root),
                                "runtime": rt})
    out = os.path.join(root, "out")
    t0 = time.perf_counter()
    port.cli_edit.main(["-m", root, "--gaussian_ply", ply, "--origin_mesh", origin,
                        "--frames", *meshes, "--out", out, "--device", "cuda"])
    cli_s = time.perf_counter() - t0
    editor = port.runtime.SceneEditor(device="cuda")
    editor.add_object(ply, origin, name="object")
    cfg = port.rasterize.RasterizerConfig(WIDTH, HEIGHT, rt.max_per_tile,
                                          rt.pair_capacity_per_gaussian,
                                          rt.row_capacity_per_gaussian)
    diffs = []
    for i, m in enumerate(meshes):
        img = port.cli_common.read_png(os.path.join(out, f"f{i:04d}_c000.png"))
        editor.deform_object("object", m)
        ref = editor.render(cam, cfg)
        assert int(ref.tile_overflow) == 0 and int(ref.rect_overflow) == 0
        want = port.cli_common.to_uint8(ref.color)
        assert img.shape == (HEIGHT, WIDTH, 3) and want.max() > 50
        diffs.append(int(np.abs(img.astype(int) - want).max()))
    r = dict(pngs=len(meshes), seconds=cli_s, max_abs_levels=diffs)
    log("[cli] edit on the card: " + json.dumps(r))
    assert max(diffs) <= 1, diffs
    return r


@contextlib.contextmanager
def clocked(torch, owner, name, rows, sync=False):
    """owner.name replaced, for the block, by a wrapper that appends
    (host ms of the call, ending in synchronize() when `sync`; its result)
    to `rows`."""
    raw = owner.__dict__[name]
    fn = raw.__func__ if isinstance(raw, staticmethod) else raw

    @functools.wraps(fn)
    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if sync:
            torch.cuda.synchronize()
        rows.append(((time.perf_counter() - t0) * 1e3, out))
        return out

    setattr(owner, name, staticmethod(timed) if isinstance(raw, staticmethod) else timed)
    try:
        yield rows
    finally:
        setattr(owner, name, raw)


def pipeline_cameras(port):
    """PIPE_VIEWS + PIPE_TEST_VIEWS orbit poses at PIPE_SIZE^2: phase 6's
    training orbit, then test views between its azimuths -> [(R, pos)]."""
    poses = []
    for i in range(PIPE_VIEWS + PIPE_TEST_VIEWS):
        az = 2 * math.pi * (i if i < PIPE_VIEWS else i - PIPE_VIEWS + 0.5) / (
            PIPE_VIEWS if i < PIPE_VIEWS else PIPE_TEST_VIEWS)
        el = 0.3 + 0.4 * math.sin(i)
        pos = 4.0 * np.array([math.cos(el) * math.sin(az), math.sin(el),
                              math.cos(el) * math.cos(az)])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        poses.append((np.stack([right, np.cross(fwd, right), fwd], axis=1), pos))
    return poses


def pose_camera(port, R, pos):
    """A port Camera at PIPE_SIZE^2 with fov 60 degrees."""
    return port.cameras.Camera(uid=0, R=R, T=-R.T @ pos, fovx=PIPE_FOVX, fovy=PIPE_FOVX,
                               image=None, width=PIPE_SIZE, height=PIPE_SIZE)


def rotmat2qvec(R):
    """COLMAP's rotation matrix -> unit quaternion (w, x, y, z), w >= 0."""
    rxx, ryx, rzx, rxy, ryy, rzy, rxz, ryz, rzz = R.flat
    k = np.array([[rxx - ryy - rzz, 0, 0, 0], [ryx + rxy, ryy - rxx - rzz, 0, 0],
                  [rzx + rxz, rzy + ryz, rzz - rxx - ryy, 0],
                  [ryz - rzy, rzx - rxz, rxy - ryx, rxx + ryy + rzz]]) / 3.0
    vals, vecs = np.linalg.eigh(k)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return q if q[0] >= 0 else -q


def filtered_png(port, img):
    """(H, W, C) uint8 as a PNG whose row y uses filter 1 + y % 4 (Sub, Up,
    Average, Paeth), forward filtering in numpy -> (its bytes, its rows
    (H, 1 + W C): filter byte, filtered bytes)."""
    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int32)
    zero_col = np.zeros((h, c), np.int32)
    up = np.concatenate([np.zeros((1, w * c), np.int32), x[:-1]])
    left = np.concatenate([zero_col, x[:, :-c]], 1)
    ul = np.concatenate([zero_col, up[:, :-c]], 1)
    p = left + up - ul
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
    ft = (1 + np.arange(h) % 4)[:, None]
    pred = np.select([ft == 1, ft == 2, ft == 3], [left, up, (left + up) >> 1], paeth)
    rows = np.concatenate([ft.astype(np.uint8), ((x - pred) & 0xFF).astype(np.uint8)], 1)
    data = (port.png.PNG_MAGIC
            + port.png._chunk(b"IHDR", np.array([w, h], ">u4").tobytes()
                              + bytes([8, port.png._COLOR_TYPE[c], 0, 0, 0]))
            + port.png._chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + port.png._chunk(b"IEND", b""))
    return data, rows


def timed(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def png_codecs(port, paths):
    """Each PNG decoded by the C++ path and the plain version (equal
    bytes); then re-written with filtered rows (`filtered_png`) and decoded
    both ways again (equal to the view), its rows unfiltered both ways on
    their own (equal bytes). -> ms per view of each."""
    ms = {k: [] for k in ("decode", "decode_plain", "filtered_decode",
                          "filtered_decode_plain", "unfilter", "unfilter_plain")}
    for path in paths:
        with open(path, "rb") as fh:
            data = fh.read()
        img, t = timed(port.png.decode_png, data)
        ms["decode"].append(t * 1e3)
        plain, t = timed(port.png.decode_png_plain, data)
        ms["decode_plain"].append(t * 1e3)
        if not np.array_equal(img, plain):
            raise AssertionError(f"{path}: the C++ PNG decode differs from the plain one")
        fdata, rows = filtered_png(port, img)
        for key, fn in (("filtered_decode", port.png.decode_png),
                        ("filtered_decode_plain", port.png.decode_png_plain)):
            back, t = timed(fn, fdata)
            ms[key].append(t * 1e3)
            if not np.array_equal(back, img):
                raise AssertionError(f"{path}, filtered rows: {key} differs from the view")
        bpp = img.shape[2]
        un, t = timed(port.png._unfilter, rows, bpp)
        ms["unfilter"].append(t * 1e3)
        un_plain, t = timed(port.png._unfilter_plain, rows, bpp)
        ms["unfilter_plain"].append(t * 1e3)
        if not np.array_equal(un, un_plain):
            raise AssertionError(f"{path}: the C++ unfilter differs from the plain one")
    return {f"{k}_ms_median": float(np.median(v)) for k, v in ms.items()} | {
        "views": len(paths)}


def write_blender_set(torch, port, model, root, poses, cfg):
    """Config 2's dataset: the slice model at PIPE_SIZE^2 from `poses` (the
    last PIPE_TEST_VIEWS the test split), RGBA PNGs through the port's
    codec (alpha = 1 - final T, color un-premultiplied), transforms_*.json
    in the OpenGL convention, and the icosphere-PROXY_SUBDIV proxy."""
    frames = []
    os.makedirs(os.path.join(root, "views"))
    for i, (R, pos) in enumerate(poses):
        cam = pose_camera(port, R, pos).arrays("cuda")
        with torch.no_grad():
            out = port.render.render(port.render.mesh_model_arrays(model, cam, SH_DEGREE),
                                     cam, cfg, torch.zeros(3, device="cuda"))
        assert int(out.tile_overflow) == 0 and int(out.rect_overflow) == 0
        alpha = (1.0 - out.final_t)[None]
        rgba = torch.cat([(out.color / alpha.clamp(min=1e-6)).clamp(0, 1), alpha])
        port.png.write_png(os.path.join(root, "views", f"r_{i:03d}.png"), (
            rgba * 255).round().to(torch.uint8).permute(1, 2, 0).cpu().numpy())
        c2w = np.eye(4)
        c2w[:3, :3], c2w[:3, 3] = R, pos
        c2w[:3, 1:3] *= -1
        frames.append({"file_path": f"views/r_{i:03d}", "transform_matrix": c2w.tolist()})
    for split, fr in (("train", frames[:PIPE_VIEWS]), ("test", frames[PIPE_VIEWS:])):
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as fh:
            json.dump({"camera_angle_x": PIPE_FOVX, "frames": fr}, fh)
    proxy = os.path.join(root, "proxy.obj")
    port.mesh_io.write_triangle_mesh(proxy, *icosphere(PROXY_SUBDIV))
    return proxy


def write_colmap_set(torch, port, model, bg, root, poses, cfg):
    """Config 4's dataset: the slice model inside phase 7's background at
    PIPE_SIZE^2 over white, RGB PNGs in images/, the object's alpha (1 -
    final T of the object alone) as gray PNGs in masks/, a binary COLMAP
    model (one PINHOLE camera) whose points3D are the background's centres
    plus BG_SURFACE_POINTS of the object's Gaussians (seeded), colored."""
    for d in ("images", "masks"):
        os.makedirs(os.path.join(root, d))
    white = torch.ones(3, device="cuda")
    images = {}
    for i, (R, pos) in enumerate(poses):
        cam = pose_camera(port, R, pos).arrays("cuda")
        with torch.no_grad():
            obj = port.render.mesh_model_arrays(model, cam, SH_DEGREE)
            alone = port.render.render(obj, cam, cfg, white)
            both = port.render.render(port.render.concat_arrays(
                obj, port.render.gaussian_model_arrays(bg, cam, 1)), cam, cfg, white)
        for out in (alone, both):
            assert int(out.tile_overflow) == 0 and int(out.rect_overflow) == 0
        name = f"{i:03d}.png"
        port.png.write_png(os.path.join(root, "images", name),
                           port.cli_common.to_uint8(both.color))
        port.png.write_png(os.path.join(root, "masks", name), (
            (1.0 - alone.final_t) * 255).round().to(torch.uint8).cpu().numpy())
        images[i + 1] = port.colmap.ColmapImage(i + 1, rotmat2qvec(R.T), -R.T @ pos, 1,
                                                name)
    focal = port.graphics.fov2focal(PIPE_FOVX, PIPE_SIZE)
    cams = {1: port.colmap.ColmapCamera(1, "PINHOLE", PIPE_SIZE, PIPE_SIZE,
                                        np.array([focal, focal, PIPE_SIZE / 2,
                                                  PIPE_SIZE / 2]))}
    rng = np.random.default_rng(SEED + 6)
    with torch.no_grad():
        alive = torch.nonzero(model.alive).flatten()
        pick = alive[torch.tensor(rng.choice(alive.numel(), BG_SURFACE_POINTS,
                                             replace=False), device="cuda")]
        xyz = torch.cat([bg.xyz, model.get_xyz()[pick]]).cpu().numpy().astype(np.float64)
        rgb = torch.cat([port.sh.sh_to_rgb(bg.features_dc[:, 0]),
                         port.sh.sh_to_rgb(model.features_dc[pick, 0])])
        rgb = (rgb.clamp(0, 1) * 255).round().cpu().numpy()
    port.colmap.write_model_binary(os.path.join(root, "sparse", "0"), cams, images,
                                   xyz, rgb, np.zeros(len(xyz)))
    return len(xyz)


def pipeline_flags(cfg):
    return ["--max_per_tile", str(cfg.max_per_tile), "--pair_capacity_per_gaussian",
            str(cfg.pair_capacity_per_gaussian), "--row_capacity_per_gaussian",
            str(cfg.row_capacity_per_gaussian), "--device", "cuda"]


def run_cli(torch, port, main, argv, trainer_cls=None):
    """One command line with the launch counters set to 0 just before it
    and read just after, its trainer's steps timed (host clock ending in
    synchronize()) and kept, its dataset load and checkpoint IO timed.
    -> (its return value, launches, {"steps" | "load" | ...: [(ms, out)]})."""
    rows = {k: [] for k in ("steps", "scene", "upload", "save_ckpt", "load_ckpt")}
    with contextlib.ExitStack() as stack:
        if trainer_cls is not None:
            stack.enter_context(clocked(torch, trainer_cls, "step", rows["steps"],
                                        sync=True))
        stack.enter_context(clocked(torch, port.scene.Scene, "__init__", rows["scene"]))
        stack.enter_context(clocked(torch, port.trainer.DeviceDataset, "from_cameras",
                                    rows["upload"], sync=True))
        for name in ("save_ckpt", "load_ckpt"):
            stack.enter_context(clocked(torch, port.trainer.MeshTrainer, name,
                                        rows[name], sync=True))
        torch.cuda.synchronize()
        reset_launches(port)                                 # main path starts
        out = main(argv)
        torch.cuda.synchronize()
        launches = read_launches(port)                       # main path ends
    return out, launches, rows


def step_summary(rows, label):
    """Median step ms, finite losses and no overflow over a run's steps."""
    ms = [t for t, _ in rows]
    m = [{k: float(v) for k, v in out.items()} for _, out in rows]
    assert all(math.isfinite(x["loss"]) for x in m), label
    assert all(x["tile_overflow"] == 0 and x["rect_overflow"] == 0 for x in m), (
        label, [(i, x["tile_overflow"], x["rect_overflow"]) for i, x in enumerate(m)
                if x["tile_overflow"] or x["rect_overflow"]][:5])
    return dict(steps=len(ms), step_ms_median=float(np.median(ms)),
                step_ms_mean=float(np.mean(ms)), loss_first=m[0]["loss"],
                loss_last=m[-1]["loss"])


def state_max_abs(torch, a, b):
    """Largest |difference| between two trainers' parameters and moments
    (inf where shapes differ)."""
    worst = 0.0
    for group in ("params", "binding", "mu", "nu", "state"):
        x, y = a.capture()[group], b.capture()[group]
        for k in x:
            worst = max(worst, float("inf") if x[k].shape != y[k].shape else
                        (x[k].double() - y[k].double()).abs().max().item())
    return worst


def phase_pipeline(torch, port, model, train_rt, tmpdir):
    """Configs 2 and 4 trained from disk through the command lines on the
    card; see the module docstring. -> (results, launches, (K1, K2, K3
    checks at a background step's shapes))."""
    res, launches, failures = {}, {}, []
    lap = Laps("pipeline")
    poses = pipeline_cameras(port)
    sched = ["--densify_from_iter", "10", "--densification_interval", "10",
             "--densify_until_iter", "35", "--opacity_reset_interval", "20",
             "--densify_grad_threshold", "1e-5"]

    # capacities for the datasets' renders and every run: the object inside
    # the background over all poses, doubled as phase 6 doubles (scales move
    # while training, the background grows), and no smaller than phase 6's
    bg = port.gaussian_ply.load_gaussian_ply(
        write_background(port, tmpdir, BG_GAUSSIANS, SEED + 5), device="cuda")
    cams = [pose_camera(port, R, pos).arrays("cuda") for R, pos in poses]
    scene_arrays = lambda c: port.render.concat_arrays(  # noqa: E731
        port.render.mesh_model_arrays(model, c, SH_DEGREE),
        port.render.gaussian_model_arrays(bg, c, 1))
    with torch.no_grad():
        cfg, largest = size_capacities(torch, port, None, cams, PIPE_SIZE, PIPE_SIZE,
                                       SH_DEGREE, "pipeline", arrays=scene_arrays)
    cfg = port.rasterize.RasterizerConfig(
        PIPE_SIZE, PIPE_SIZE, max(2 * cfg.max_per_tile, train_rt.max_per_tile),
        max(2 * cfg.pair_capacity_per_gaussian, train_rt.pair_capacity_per_gaussian),
        max(2 * cfg.row_capacity_per_gaussian, train_rt.row_capacity_per_gaussian))
    log(f"[pipeline] largest tile of the object in the background {max(largest)}; "
        f"{cfg}")
    lap("capacities")

    # ---- config 2 from disk: uninterrupted, then resumed from the checkpoint
    data2 = os.path.join(tmpdir, "blender")
    t0 = time.perf_counter()
    proxy = write_blender_set(torch, port, model, data2, poses, cfg)
    log(f"[pipeline] config 2 dataset: {len(poses)} RGBA PNGs at {PIPE_SIZE}x{PIPE_SIZE} "
        f"written in {time.perf_counter() - t0:.1f} s")
    views = sorted(os.path.join(data2, "views", n) for n in os.listdir(os.path.join(
        data2, "views")))
    lap("config 2 dataset")
    res["png_codecs"] = png_codecs(port, views[:PNG_CODEC_VIEWS])
    log("[pipeline] host PNG codecs (C++ and plain, ms per view): "
        + json.dumps(res["png_codecs"]))
    lap("png codecs")
    base = ["-s", data2, "--input_mesh", proxy, "--init_target", str(INIT_TARGET),
            "--eval", "--iterations", str(PIPE_ITERS), "--save_iterations",
            str(PIPE_ITERS), "--test_iterations", str(PIPE_ITERS), *sched,
            *pipeline_flags(cfg)]
    model_a, model_b = (os.path.join(tmpdir, n) for n in ("model_a", "model_b"))
    half = PIPE_ITERS // 2
    tr_a, la, rows_a = run_cli(torch, port, port.cli_train_mesh.main, base + [
        "-m", model_a, "--checkpoint_iterations", str(half)], port.trainer.MeshTrainer)
    lap("config 2 run")
    ckpt = os.path.join(model_a, f"chkpnt{half}.ckpt")
    tr_b, lb, rows_b = run_cli(torch, port, port.cli_train_mesh.main, base + [
        "-m", model_b, "--start_checkpoint", ckpt], port.trainer.MeshTrainer)
    lap("config 2 resumed run")
    resume_max_abs = state_max_abs(torch, tr_a, tr_b)
    res["config2"] = dict(
        **step_summary(rows_a["steps"], "config 2"), gaussians=int(tr_a.model.alive.sum()),
        capacity=tr_a.model.capacity, load_s=(rows_a["scene"][0][0]
                                              + rows_a["upload"][0][0]) / 1e3,
        checkpoint_mb=os.path.getsize(ckpt) / 1e6,
        checkpoint_save_s=rows_a["save_ckpt"][0][0] / 1e3,
        checkpoint_load_s=rows_b["load_ckpt"][0][0] / 1e3,
        resumed_steps=len(rows_b["steps"]), resume_max_abs=resume_max_abs,
        resume_global_it=(tr_a.global_it, tr_b.global_it))
    log("[pipeline] config 2: " + json.dumps(res["config2"]))
    launches["config2"] = {k: la[k] + lb[k] for k in la}
    want_a = {"K1": PIPE_ITERS + PIPE_TEST_VIEWS, "K2": PIPE_ITERS, "K3": PIPE_ITERS}
    want_b = {"K1": half + PIPE_TEST_VIEWS, "K2": half, "K3": half}
    assert (la, lb) == (want_a, want_b), (la, lb)
    for name, p in tr_a.model.named_parameters():
        assert torch.isfinite(p).all(), name
    if resume_max_abs != 0 or tr_a.global_it != tr_b.global_it:
        failures.append(f"resumed run differs from the uninterrupted one: max-abs "
                        f"{resume_max_abs}")
    # phase 9e writes this set again as WebPs and holds its targets to these
    res["config2_scene"] = dict(root=data2, proxy=proxy, cfg=cfg, sched=sched,
                                images=tr_a.ds.images.cpu(), masks=tr_a.ds.masks.cpu(),
                                campos=tr_a.ds.campos.cpu())
    del tr_a, tr_b

    # ---- config 4: mesh with masks, then the background, then render --with_bg
    data4, model4 = (os.path.join(tmpdir, n) for n in ("colmap", "model4"))
    t0 = time.perf_counter()
    n_points = write_colmap_set(torch, port, model, bg, data4, poses, cfg)
    log(f"[pipeline] config 4 dataset: {len(poses)} RGB PNGs + masks at "
        f"{PIPE_SIZE}x{PIPE_SIZE}, {n_points} SfM points, written in "
        f"{time.perf_counter() - t0:.1f} s")
    lap("config 4 dataset")
    n_test4 = len(range(0, len(poses), 8))                   # llffhold 8
    tr_c, lc, rows_c = run_cli(torch, port, port.cli_train_mesh.main, [
        "-s", data4, "-m", model4, "--input_mesh", proxy, "--is_exist_bg",
        "--init_target", str(INIT_TARGET), "--eval", "--iterations", str(PIPE_ITERS),
        "--save_iterations", str(PIPE_ITERS), "--test_iterations", str(PIPE_ITERS),
        *sched, *pipeline_flags(cfg)], port.trainer.MeshTrainer)
    assert lc == {"K1": PIPE_ITERS + n_test4, "K2": PIPE_ITERS, "K3": PIPE_ITERS}, lc
    lap("config 4 mesh run")

    # The background: the default threshold 2e-4 is set for 30K-step runs;
    # grads_avg here is taken over BG_ITERS steps of a fresh model, so the
    # smoke lowers it to 1e-5 as phase 6 does (the densify logs its
    # quantiles). The mesh run's shrunk schedule is undone for it: the
    # window and reset interval of the defaults, its own densify start.
    grads_seen = []
    densify = port.bg_trainer.BgTrainer.densify

    def densify_logged(self):
        g = port.densify.grads_avg(self.model.state)[self.model.alive]
        q = torch.quantile(g, torch.tensor([0.5, 0.9, 0.99, 0.999], device=g.device))
        grads_seen.append(dict(quantiles=q.tolist(), max=g.max().item()))
        return densify(self)

    port.bg_trainer.BgTrainer.densify = densify_logged
    try:
        tr_d, ld, rows_d = run_cli(torch, port, port.cli_train_bg.main, [
            "-m", model4, "--iterations", str(BG_ITERS), "--densify_from_iter",
            str(BG_DENSIFY_FROM), "--densify_until_iter", "15000",
            "--opacity_reset_interval", "3000", "--densify_grad_threshold", "1e-5",
            "--remove_neighbor_gaussian_iterations", str(BG_PRUNE_AT),
            "--device", "cuda"], port.bg_trainer.BgTrainer)
    finally:
        port.bg_trainer.BgTrainer.densify = densify
    assert ld == {"K1": BG_ITERS, "K2": BG_ITERS, "K3": BG_ITERS}, ld
    lap("config 4 background run")
    for name, p in list(tr_c.model.named_parameters()) + list(
            tr_d.model.named_parameters()):
        assert torch.isfinite(p).all(), name
    events = {kind: info for _, kind, info in tr_d.events}
    log(f"[pipeline] background events: {tr_d.events}; grads_avg at the densify "
        f"(median / p90 / p99 / p99.9, max): {grads_seen}")
    if [(it, kind) for it, kind, _ in tr_d.events] != [
            (BG_PRUNE_AT, "prune_near_mesh"), (BG_DENSIFY_FROM, "opacity_reset"),
            (BG_ITERS, "densify")]:
        failures.append(f"background events {tr_d.events}")
    elif events["prune_near_mesh"]["n_retired"] < 1 or (
            events["densify"]["n_cloned"] + events["densify"]["n_split"] < 1):
        failures.append(f"the prune retired or the densify added nothing: {events}")
    prof = phase_profile(torch, lambda i: tr_d.train(1, log_every=10 ** 9), 3, "step",
                         "bg profile")
    lap("background profile")

    # the kernels on the arguments of one more background step: the
    # concatenated table (background capacity rows, then the frozen
    # foreground's), its pair domain, cotangents from the real loss
    seen = capture_step(torch, port, tr_d)
    k1, _, _, blended = check_k1(torch, port.tile_blend, seen["K1"],
                                 tr_d.rt.max_per_tile)
    log("[pipeline] K1 at the background step's shapes: " + json.dumps(k1))
    rows, grouped_pos, seg_starts = seen["K3"]
    k2, k3 = check_k2_k3(torch, port, seen["K2"], grouped_pos, seg_starts,
                         blended, step_rows=rows)
    log("[pipeline] K2 at the background step's shapes: " + json.dumps(k2))
    log("[pipeline] K3 at the background step's shapes: " + json.dumps(k3))
    del seen, rows, grouped_pos, seg_starts
    lap("background step kernels")

    # render --with_bg at the background's iteration: the foreground's PLY
    # of iteration PIPE_ITERS copied beside it (the two runs' lengths differ)
    pc = os.path.join(model4, "point_cloud")
    shutil.copy(os.path.join(pc, f"iteration_{PIPE_ITERS}", "point_cloud.ply"),
                os.path.join(pc, f"iteration_{BG_ITERS}", "point_cloud.ply"))
    _, lr, _ = run_cli(torch, port, port.cli_render.main, [
        "-m", model4, "--with_bg", "--skip_train", "--device", "cuda"])
    assert lr == {"K1": n_test4, "K2": 0, "K3": 0}, lr
    fg4, _ = port.gaussian_ply.load_mesh_gaussian_ply(
        os.path.join(pc, f"iteration_{BG_ITERS}", "point_cloud.ply"), device="cuda")
    bg4 = port.gaussian_ply.load_gaussian_ply(
        os.path.join(pc, f"iteration_{BG_ITERS}", "bg_point_cloud.ply"), device="cuda")
    scene4 = port.scene.Scene(port.config.ModelParams(source_path=data4, eval=True),
                              shuffle=False)
    levels = []
    with torch.no_grad():
        for i, cam in enumerate(scene4.test_cameras):
            ca = cam.arrays("cuda")
            out = port.render.render(port.render.concat_arrays(
                port.render.mesh_model_arrays(fg4, ca, SH_DEGREE),
                port.render.gaussian_model_arrays(bg4, ca, SH_DEGREE)), ca, cfg,
                torch.ones(3, device="cuda"))
            assert int(out.tile_overflow) == 0 and int(out.rect_overflow) == 0
            png = port.png.read_png(os.path.join(model4, "test", f"ours_{BG_ITERS}",
                                                 "renders", f"{i:05d}.png"))
            levels.append(int(np.abs(png.astype(int)
                                     - port.cli_common.to_uint8(out.color)).max()))
    res["config4"] = dict(
        mesh=dict(**step_summary(rows_c["steps"], "config 4 mesh"),
                  gaussians=int(tr_c.model.alive.sum()),
                  load_s=(rows_c["scene"][0][0] + rows_c["upload"][0][0]) / 1e3),
        bg=dict(**step_summary(rows_d["steps"], "config 4 background"),
                capacity=tr_d.model.capacity, alive=int(tr_d.model.alive.sum()),
                fg_gaussians=tr_d.fg.capacity, sfm_points=n_points,
                load_s=(rows_d["scene"][0][0] + rows_d["upload"][0][0]) / 1e3,
                device_busy_ms=prof["busy_ms"], idle_share=prof["idle_share"],
                device_operations=prof["launches"], events=events),
        render_views=n_test4, render_png_max_levels=levels)
    log("[pipeline] config 4: " + json.dumps(res["config4"]))
    lap("render --with_bg")
    launches["config4"] = {k: lc[k] + ld[k] + lr[k] for k in lc}
    if max(levels) != 0:
        failures.append(f"--with_bg PNGs differ from the in-process render by {levels}")
    assert not failures, failures
    return res, {k: sum(x[k] for x in launches.values()) for k in ("K1", "K2", "K3")}, (
        k1, k2, k3)


def eval_cameras(port):
    """EVAL_VIEWS orbit views of the object at EVAL_WIDTH x EVAL_HEIGHT ->
    [(R, pos, port Camera)], fov 60 degrees across."""
    fovy = port.graphics.focal2fov(port.graphics.fov2focal(EVAL_FOVX, EVAL_WIDTH),
                                   EVAL_HEIGHT)
    out = []
    for i in range(EVAL_VIEWS):
        az, el = 2 * math.pi * i / EVAL_VIEWS, 0.3 + 0.3 * math.sin(1.3 * i)
        pos = 4.0 * np.array([math.cos(el) * math.sin(az), math.sin(el),
                              math.cos(el) * math.cos(az)])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(fwd, right), fwd], axis=1)
        out.append((R, pos, port.cameras.Camera(
            uid=i, R=R, T=-R.T @ pos, fovx=EVAL_FOVX, fovy=fovy, image=None,
            width=EVAL_WIDTH, height=EVAL_HEIGHT)))
    return out


def write_eval_set(torch, port, model, root, cams, cfg):
    """The eval scene: the slice model over white at EVAL_WIDTH x
    EVAL_HEIGHT, JPEGs through `write_jpeg` (EVAL_QUALITY, 4:2:0), a binary
    COLMAP model (one PINHOLE camera; points3D 1,000 of the object's
    Gaussians, seeded, coloured), an icosphere-2 proxy. Each JPEG decoded
    again by `read_jpeg` (C++) and `read_jpeg_plain`, equal bytes: ->
    (proxy path, round-trip PSNR per view, (C++, plain) decode s per view,
    the decoded test views {file name: array})."""
    os.makedirs(os.path.join(root, "images"))
    white = torch.ones(3, device="cuda")
    psnrs, decode_s, decoded, images = [], [], {}, {}
    for i, (R, pos, cam) in enumerate(cams):
        ca = cam.arrays("cuda")
        with torch.no_grad():
            out = port.render.render(port.render.mesh_model_arrays(model, ca, SH_DEGREE),
                                     ca, cfg, white)
        assert int(out.tile_overflow) == 0 and int(out.rect_overflow) == 0
        u8 = port.cli_common.to_uint8(out.color)
        name = f"{i:03d}.jpg"
        path = os.path.join(root, "images", name)
        port.jpeg.write_jpeg(path, u8, quality=EVAL_QUALITY, subsampling="4:2:0")
        back, t = timed(port.jpeg.read_jpeg, path)
        t_plain = None
        if i < EVAL_PLAIN_VIEWS:
            plain, t_plain = timed(port.jpeg.read_jpeg_plain, path)
            if not np.array_equal(back, plain):
                raise AssertionError(f"{name}: the C++ JPEG decode differs from the plain one")
        decode_s.append((t, t_plain))
        mse = np.mean((back.astype(np.float64) - u8) ** 2)
        psnrs.append(float(10 * np.log10(255.0 ** 2 / mse)))
        if i % 8 == 0:                                   # llffhold 8: the test views
            decoded[name] = back
        images[i + 1] = port.colmap.ColmapImage(i + 1, rotmat2qvec(R.T), -R.T @ pos, 1,
                                                name)
    f = port.graphics.fov2focal(EVAL_FOVX, EVAL_WIDTH)
    colmap_cams = {1: port.colmap.ColmapCamera(1, "PINHOLE", EVAL_WIDTH, EVAL_HEIGHT,
                                               np.array([f, f, EVAL_WIDTH / 2,
                                                         EVAL_HEIGHT / 2]))}
    rng = np.random.default_rng(SEED + 9)
    with torch.no_grad():
        alive = torch.nonzero(model.alive).flatten()
        pick = alive[torch.tensor(rng.choice(alive.numel(), BG_SURFACE_POINTS,
                                             replace=False), device="cuda")]
        xyz = model.get_xyz()[pick].cpu().numpy().astype(np.float64)
        rgb = (port.sh.sh_to_rgb(model.features_dc[pick, 0]).clamp(0, 1) * 255).round()
    port.colmap.write_model_binary(os.path.join(root, "sparse", "0"), colmap_cams, images,
                                   xyz, rgb.cpu().numpy(), np.zeros(len(xyz)))
    proxy = os.path.join(root, "ico2.obj")
    port.mesh_io.write_triangle_mesh(proxy, *icosphere(PROXY_SUBDIV))
    return proxy, psnrs, decode_s, decoded


@contextlib.contextmanager
def recording_renders(port, into):
    """`models.render.render` appending each call's (camera, capacities,
    background, tile overflow, rect overflow) to `into`."""
    kept = port.render.render

    def record(arrays, cam, cfg, bg_color, *rest):
        out = kept(arrays, cam, cfg, bg_color, *rest)
        into.append((cam, cfg, bg_color, int(out.tile_overflow), int(out.rect_overflow)))
        return out

    port.render.render = record
    try:
        yield
    finally:
        port.render.render = kept


def phase_eval(torch, port, model, train_rt, tmpdir):
    """The quality protocol through `cli.full_eval` on the card; see the
    module docstring. -> (results, launches, (K1, K2, K3 checks at a
    1600x900 training step's shapes))."""
    t_phase = time.perf_counter()
    cams = eval_cameras(port)
    tw, th = port.cameras.pick_resolution(EVAL_WIDTH, EVAL_HEIGHT, -1)
    assert (tw, th) == (1600, 900), (tw, th)
    with torch.no_grad():
        gt_cfg, _ = size_capacities(torch, port, model, [c.arrays("cuda") for *_, c in cams],
                                    EVAL_WIDTH, EVAL_HEIGHT, SH_DEGREE, "eval")
        scaled = [dataclasses.replace(c, width=tw, height=th).arrays("cuda")
                  for *_, c in cams]
        cfg, largest = size_capacities(torch, port, model, scaled, tw, th, SH_DEGREE,
                                       "eval")
    # doubled as phase 8 doubles (the student's scales move while training)
    cfg = port.rasterize.RasterizerConfig(
        tw, th, max(2 * cfg.max_per_tile, train_rt.max_per_tile),
        max(2 * cfg.pair_capacity_per_gaussian, train_rt.pair_capacity_per_gaussian),
        max(2 * cfg.row_capacity_per_gaussian, train_rt.row_capacity_per_gaussian))
    log(f"[eval] largest tile at {tw}x{th} {max(largest)}; training {cfg}")

    base, out_root = os.path.join(tmpdir, "eval_data"), os.path.join(tmpdir, "eval_out")
    t0 = time.perf_counter()
    proxy, psnrs, decode_s, decoded = write_eval_set(
        torch, port, model, os.path.join(base, "s"), cams, gt_cfg)
    megapixels = EVAL_WIDTH * EVAL_HEIGHT / 1e6
    res = dict(jpeg_psnr_min=min(psnrs), jpeg_psnr_mean=float(np.mean(psnrs)),
               jpeg_bytes_mean=float(np.mean([os.path.getsize(os.path.join(
                   base, "s", "images", n)) for n in sorted(os.listdir(
                       os.path.join(base, "s", "images")))])),
               jpeg_decode_s_per_mp=float(np.median([t for t, _ in decode_s])) / megapixels,
               jpeg_decode_plain_s_per_mp=float(np.median(
                   [t for _, t in decode_s if t is not None])) / megapixels,
               dataset_write_s=time.perf_counter() - t0)
    log(f"[eval] {EVAL_VIEWS} JPEGs at {EVAL_WIDTH}x{EVAL_HEIGHT} (quality "
        f"{EVAL_QUALITY}, 4:2:0): round-trip PSNR min {min(psnrs):.2f} dB, mean "
        f"{np.mean(psnrs):.2f}; decode {res['jpeg_decode_s_per_mp']:.4f} s/MP (plain "
        f"{res['jpeg_decode_plain_s_per_mp']:.4f}); written and decoded both ways "
        f"in {res['dataset_write_s']:.1f} s")
    if min(psnrs) < EVAL_MIN_PSNR:
        raise AssertionError(f"JPEG round trip below {EVAL_MIN_PSNR} dB: {psnrs}")

    # full_eval: train_mesh -> render -> metrics, each inner command line's
    # launches by difference of the counters, its trainer kept
    sched = ["--densify_from_iter", "10", "--densification_interval", "10",
             "--densify_until_iter", "35", "--opacity_reset_interval", "20",
             "--densify_grad_threshold", "1e-5"]
    inner, trainers, renders = {}, [], []
    kept = {name: getattr(port, f"cli_{name}").main for name in ("train_mesh", "render",
                                                                 "metrics")}

    def counted(name):
        def run(argv):
            torch.cuda.synchronize()
            before = read_launches(port)
            with (recording_renders(port, renders) if name == "render"
                  else contextlib.nullcontext()):
                out = kept[name](argv)
            torch.cuda.synchronize()
            inner[name] = {k: v - before[k] for k, v in read_launches(port).items()}
            if name == "train_mesh":
                trainers.append(out)
            return out
        return run

    for name in kept:
        getattr(port, f"cli_{name}").main = counted(name)
    lpips_rows = []
    try:
        with clocked(torch, port.lpips.LPIPS, "__call__", lpips_rows, sync=True):
            _, launches, rows = run_cli(torch, port, port.cli_full_eval.main, [
                "--base", base, "--scenes", "s", "--meshes", proxy, "--output", out_root,
                "--iterations", str(EVAL_ITERS), "--device", "cuda",
                "--init_target", str(INIT_TARGET), "--max_per_tile", str(cfg.max_per_tile),
                "--pair_capacity_per_gaussian", str(cfg.pair_capacity_per_gaussian),
                "--row_capacity_per_gaussian", str(cfg.row_capacity_per_gaussian),
                *sched], port.trainer.MeshTrainer)
            model_dir = os.path.join(out_root, "s")
            _, metric_launches, _ = run_cli(torch, port, port.cli_metrics.main, [
                "-m", model_dir, "--lpips_uncalibrated", "--device", "cuda"])
    finally:
        for name, fn in kept.items():
            getattr(port, f"cli_{name}").main = fn
    log(f"[eval] launches: full_eval {launches} (train_mesh {inner['train_mesh']}, "
        f"render {inner['render']}, metrics {inner['metrics']}); metrics "
        f"--lpips_uncalibrated {metric_launches}")
    n_test = len(range(0, EVAL_VIEWS, 8))
    assert inner["train_mesh"] == {"K1": EVAL_ITERS, "K2": EVAL_ITERS, "K3": EVAL_ITERS}, inner
    assert inner["render"] == {"K1": n_test, "K2": 0, "K3": 0}, inner
    assert inner["metrics"] == metric_launches == {"K1": 0, "K2": 0, "K3": 0}, inner
    assert launches == {k: inner["train_mesh"][k] + inner["render"][k] for k in launches}
    trainer = trainers[0]
    for name, p in trainer.model.named_parameters():
        assert torch.isfinite(p).all(), name
    steps = step_summary(rows["steps"], "eval")
    ds = trainer.ds
    assert tuple(ds.images.shape[-2:]) == (th, tw), tuple(ds.images.shape)

    # the written PNGs: gt equal to the resized JPEGs; metrics in process
    method = os.path.join(model_dir, "test", f"ours_{EVAL_ITERS}")
    names = sorted(os.listdir(os.path.join(method, "gt")))
    assert len(names) == n_test, names
    resample_ms, resample_plain_ms, psnr_in, ssim_in = [], [], [], []
    for i, name in enumerate(names):
        want, t = timed(port.resample.resize, decoded[f"{8 * i:03d}.jpg"], (tw, th))
        resample_ms.append(t * 1e3)
        plain, t = timed(port.resample.resize_plain, decoded[f"{8 * i:03d}.jpg"], (tw, th))
        resample_plain_ms.append(t * 1e3)
        if not np.array_equal(want, plain):
            raise AssertionError(f"{name}: the C++ resize differs from the plain one")
        gt = port.png.read_png(os.path.join(method, "gt", name))
        if not np.array_equal(gt, want):
            raise AssertionError(f"gt {name} differs from resize(read_jpeg()) by "
                                 f"{int(np.abs(gt.astype(int) - want).max())} levels")
        render = port.png.read_png(os.path.join(method, "renders", name))
        assert render.shape == (th, tw, 3), render.shape
        as_t = lambda a: torch.from_numpy(a.astype(np.float32) / 255.0).permute(  # noqa: E731
            2, 0, 1).contiguous().cuda()
        with torch.no_grad():
            psnr_in.append(float(port.loss.psnr(as_t(render), as_t(gt))))
            ssim_in.append(float(port.loss.ssim(as_t(render), as_t(gt))))
    # the rendered test views: no overflow in `render`'s renders, and each
    # PNG equal to an in-process render of the trained model on `render`'s
    # camera and capacities; the share of each test view the object covers
    # (final T < 0.5 in the ground truth's render), beside the same share
    # in phase 8's config-2 test views
    assert len(renders) == n_test, len(renders)
    sh_degree = port.config.load_cfg(model_dir)["model"]["sh_degree"]
    render_levels, coverage = [], []
    with torch.no_grad():
        for i, (ca, rcfg, bg_color, tile_of, rect_of) in enumerate(renders):
            assert tile_of == 0 and rect_of == 0, (i, tile_of, rect_of)
            assert (rcfg.width, rcfg.height) == (tw, th), rcfg
            out = port.render.render(port.render.mesh_model_arrays(
                trainer.model, ca, sh_degree), ca, rcfg, bg_color)
            assert int(out.tile_overflow) == 0 and int(out.rect_overflow) == 0
            png = port.png.read_png(os.path.join(method, "renders", names[i]))
            render_levels.append(int(np.abs(png.astype(int)
                                            - port.cli_common.to_uint8(out.color)).max()))
            gt_out = port.render.render(port.render.mesh_model_arrays(model, ca, SH_DEGREE),
                                        ca, cfg, bg_color)
            assert int(gt_out.tile_overflow) == 0 and int(gt_out.rect_overflow) == 0
            coverage.append(float((gt_out.final_t < 0.5).float().mean()))
        pipe_cfg = port.rasterize.RasterizerConfig(
            PIPE_SIZE, PIPE_SIZE, cfg.max_per_tile, cfg.pair_capacity_per_gaussian,
            cfg.row_capacity_per_gaussian)
        pipe_coverage = []
        for R, pos in pipeline_cameras(port)[PIPE_VIEWS:]:
            ca = pose_camera(port, R, pos).arrays("cuda")
            out = port.render.render(port.render.mesh_model_arrays(model, ca, SH_DEGREE),
                                     ca, pipe_cfg, torch.ones(3, device="cuda"))
            assert int(out.tile_overflow) == 0 and int(out.rect_overflow) == 0
            pipe_coverage.append(float((out.final_t < 0.5).float().mean()))
    if max(render_levels) != 0:
        raise AssertionError(f"render's PNGs differ from the in-process render of the "
                             f"trained model by {render_levels} levels")
    with open(os.path.join(model_dir, "results.json")) as fh:
        results = json.load(fh)[f"ours_{EVAL_ITERS}"]
    log(f"[eval] results.json: {json.dumps(results)}")
    for key, mine in (("PSNR", np.mean(psnr_in)), ("SSIM", np.mean(ssim_in))):
        if abs(results[key] - mine) > 1e-5 * max(1.0, abs(mine)):
            raise AssertionError(f"results.json {key} {results[key]} vs in-process {mine}")
    assert results["LPIPS"] is None and "LPIPS_note" in results, results
    assert math.isfinite(results["LPIPS_uncalibrated"]), results
    assert len(lpips_rows) == n_test, len(lpips_rows)
    res.update(
        **steps, gaussians=int(trainer.model.alive.sum()), capacity=trainer.model.capacity,
        train_views=int(ds.images.shape[0]), test_views=n_test, size=[tw, th],
        load_s=(rows["scene"][0][0] + rows["upload"][0][0]) / 1e3,
        render_load_s=rows["scene"][1][0] / 1e3,
        resample_ms_per_image=float(np.median(resample_ms)),
        resample_plain_ms_per_image=float(np.median(resample_plain_ms)),
        lpips_ms_per_view=float(np.median([t for t, _ in lpips_rows])),
        psnr=results["PSNR"], ssim=results["SSIM"],
        lpips_uncalibrated=results["LPIPS_uncalibrated"],
        render_png_max_levels=render_levels, object_coverage=coverage,
        phase8_object_coverage=pipe_coverage)
    log("[eval] " + json.dumps(res))

    # the kernels on the arguments of one more training step at 1600x900
    # (the table at training capacity with its dead rows, cotangents from
    # the real loss)
    t0 = time.perf_counter()
    seen = capture_step(torch, port, trainer)
    k1, _, _, blended = check_k1(torch, port.tile_blend, seen["K1"],
                                 trainer.rt.max_per_tile)
    log("[eval] K1 at the 1600x900 step's shapes: " + json.dumps(k1))
    rows, grouped_pos, seg_starts = seen["K3"]
    k2, k3 = check_k2_k3(torch, port, seen["K2"], grouped_pos, seg_starts,
                         blended, step_rows=rows)
    log("[eval] K2 at the 1600x900 step's shapes: " + json.dumps(k2))
    log("[eval] K3 at the 1600x900 step's shapes: " + json.dumps(k3))
    res.update(kernel_check_s=time.perf_counter() - t0,
               phase_s=time.perf_counter() - t_phase)
    scene = dict(root=os.path.join(base, "s"), cams=cams, gt_cfg=gt_cfg, cfg=cfg,
                 proxy=proxy, sched=sched, targets=ds)
    return res, launches, (k1, k2, k3), scene


# ------------------------------------------------------------------ phase 9b

def jpeg_scan_starts(data: bytes) -> list:
    """A JPEG's bytes -> the offset of each SOS marker: the segments walked
    by their lengths, each scan's entropy-coded data to the next marker that
    is neither a stuffed zero nor a restart."""
    starts, pos = [], 2
    while pos + 4 <= len(data) and data[pos + 1] != 0xD9:
        marker = data[pos + 1]
        if marker == 0xDA:
            starts.append(pos)
        pos += 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
        while marker == 0xDA and not (data[pos] == 0xFF and not (
                data[pos + 1] == 0 or 0xD0 <= data[pos + 1] <= 0xD7)):
            pos += 1
    return starts


def centre_crop(img, size=CROP_9F):
    """The (width, height) centre of an image, contiguous."""
    w, h = size
    y0, x0 = (img.shape[0] - h) // 2, (img.shape[1] - w) // 2
    return np.ascontiguousarray(img[y0:y0 + h, x0:x0 + w])


def reader_phase(i):
    """The reader phase whose file of phase 9's view i the shared training
    (9h) takes: READER_9M's three views are 9m's (one each taken from 9k,
    9l and 9f, which had three); the others rotate over the nine phases
    before 9m, each view 5 phases on from the one before (5 is prime to 9),
    each octet of views starting one phase on. So the test views (every
    8th: llffhold 8) fall to 9b, 9c and 9d, each phase keeps two or three of
    the 21 training views, and none of them is a row that decodes with an
    alpha. (No rotation of this form over all ten phases meets the last
    two conditions.)"""
    if i in READER_9M:
        return "9m"
    return READER_PHASES[(5 * i + 6 * (i // 8)) % (len(READER_PHASES) - 1)]


def phase_progressive(torch, port, model, scene, tmpdir):
    """Phase 9b (see the module docstring) on phase 9's `scene` ->
    (results, {view: (file, None where it decodes to phase 9's baseline
    decode, else its decode)} for the shared training)."""
    t_phase = time.perf_counter()
    fixtures = fixture_digests(port, "jpeg_lossless",
                               lambda port, p: port.jpeg.read_jpeg_plain(p), "lossless JPEG",
                               least=20)
    arith_fixtures = fixture_digests(port, "jpeg_arith",
                                     lambda port, p: port.jpeg.read_jpeg_plain(p),
                                     "arithmetic JPEG", least=20)
    root = os.path.join(tmpdir, "progressive_data")
    os.makedirs(root)
    white = torch.ones(3, device="cuda")
    times = {k: [] for k in ("write", "decode", "baseline")}
    lossless, arith = {}, {}
    views = {}
    taken = [i for i in range(len(scene["cams"])) if reader_phase(i) == "9b"]
    assert taken[0] == 0, taken               # view 0 gives the crop and the cut scans
    assert {v for _, v in LOSSLESS_9B} <= set(taken) and LOSSLESS_9B_TRAIN in taken, taken
    assert {v for _, v in ARITH_9B} <= set(taken) and ARITH_9B_TRAIN in taken, taken
    for i in taken:
        _, _, cam = scene["cams"][i]
        ca = cam.arrays("cuda")
        with torch.no_grad():
            out = port.render.render(port.render.mesh_model_arrays(model, ca, SH_DEGREE),
                                     ca, scene["gt_cfg"], white)
        assert int(out.tile_overflow) == 0 and int(out.rect_overflow) == 0
        u8 = port.cli_common.to_uint8(out.color)
        name = f"{i:03d}.jpg"
        path = os.path.join(root, name)
        _, t = timed(port.jpeg.write_jpeg, path, u8, EVAL_QUALITY, "4:2:0", True)
        times["write"].append(t)
        got, t = timed(port.jpeg.read_jpeg, path)
        times["decode"].append(t)
        base, t = timed(port.jpeg.read_jpeg, os.path.join(scene["root"], "images", name))
        times["baseline"].append(t)
        if not np.array_equal(got, base):
            raise AssertionError(
                f"{name}: the progressive file decodes to other bytes than the baseline "
                f"one, by {int(np.abs(got.astype(int) - base).max())} levels")
        views[i] = (path, None)
        for kind in (k for k, v in ARITH_9B if v == i):
            huffman = path if kind == "sof10" else os.path.join(scene["root"], "images", name)
            arith[kind] = arith_row(port, kind, u8, base, huffman, root, i, tmpdir)
            if i == ARITH_9B_TRAIN:
                views[i] = (arith[kind]["path"], None)
        for predictor in (p for p, v in LOSSLESS_9B if v == i):
            lossless[predictor] = lossless_row(port, predictor, u8, root, i, tmpdir)
            if i == LOSSLESS_9B_TRAIN:
                views[i] = (lossless[predictor]["path"], u8)
        if i == 0:                        # the plain decoder on the centre crop
            crop = os.path.join(tmpdir, "progressive_crop.jpg")
            port.jpeg.write_jpeg(crop, centre_crop(u8), EVAL_QUALITY, "4:2:0", True)
            small, t_cpp = timed(port.jpeg.read_jpeg, crop)
            plain, t_plain = timed(port.jpeg.read_jpeg_plain, crop)
            if not np.array_equal(small, plain):
                raise AssertionError("the C++ progressive decode of the centre crop differs "
                                     "from the plain one")
    megapixels = EVAL_WIDTH * EVAL_HEIGHT / 1e6
    crop_mp = CROP_9F[0] * CROP_9F[1] / 1e6
    per_mp = {k: float(np.median(v)) / megapixels for k, v in times.items()}
    sizes = [os.path.getsize(p) for p, _ in views.values()]
    with open(views[0][0], "rb") as fh:
        data = fh.read()
    starts = jpeg_scan_starts(data)
    assert len(starts) == 10 and b"\xff\xc2" in data[:starts[0]], len(starts)
    crafted = os.path.join(tmpdir, "unrefined.jpg")
    with open(crafted, "wb") as fh:
        fh.write(data[:starts[-3]] + b"\xff\xd9")
    for read in (port.jpeg.read_jpeg, port.jpeg.read_jpeg_plain):
        try:
            read(crafted)
        except ValueError as err:
            if "coefficients left unrefined" not in str(err):
                raise
        else:
            raise AssertionError(f"{read.__name__} decoded a file with unrefined "
                                 "coefficients")
    log(f"[progressive] {len(sizes)} progressive JPEGs at {EVAL_WIDTH}x{EVAL_HEIGHT} "
        f"(quality {EVAL_QUALITY}, 4:2:0, 10 scans), {np.mean(sizes):.0f} bytes each: "
        f"decode {per_mp['decode']:.4f} s/MP (the baseline files {per_mp['baseline']:.4f}; "
        f"at {CROP_9F[0]}x{CROP_9F[1]} {t_cpp / crop_mp:.4f}, plain {t_plain / crop_mp:.4f}); "
        f"write {np.median(times['write']):.2f} s a view (views {taken}); C++ = baseline "
        "bytes on every view, C++ = plain on the crop; view 0 cut after 7 scans raises "
        "through both decoders")
    for p, r in lossless.items():
        r.pop("path")
        r["decode_vs_baseline_jpeg"] = r["decode_s_per_mp"] / per_mp["baseline"]
        log(f"[progressive] lossless JPEG, predictor {p}, view {r['view']}: "
            f"{r['bytes']} bytes ({r['bytes'] / np.mean(sizes):.2f}x the progressive file); "
            f"decode {r['decode_s_per_mp']:.4f} s/MP ({r['decode_vs_baseline_jpeg']:.2f}x the "
            f"baseline files); at {CROP_9F[0]}x{CROP_9F[1]} plain / C++ "
            f"{r['plain_vs_cpp']:.1f}; write {r['write_s']:.2f} s; C++ = the rendered bytes "
            "on the view, C++ = plain = the crop on the crop")
    for kind, r in arith.items():
        r.pop("path")
        r["decode_vs_baseline_jpeg"] = r["decode_s_per_mp"] / per_mp["baseline"]
        log(f"[progressive] arithmetic JPEG, {kind}, view {r['view']}: {r['bytes']} bytes "
            f"({r['bytes_vs_huffman']:.3f}x its Huffman file); decode "
            f"{r['decode_s_per_mp']:.4f} s/MP ({r['decode_vs_baseline_jpeg']:.2f}x the "
            f"baseline files); at {ARITH_CROP_9B[0]}x{ARITH_CROP_9B[1]} plain "
            f"{r['crop_plain_s_per_mp']:.3f} s/MP, plain / C++ {r['plain_vs_cpp']:.1f}; write "
            f"{r['write_s']:.2f} s; C++ = phase 9's baseline bytes on the view, C++ = plain = "
            "the Huffman crop on the crop")
    res = dict(views=len(sizes), bytes_mean=float(np.mean(sizes)),
               decode_s_per_mp=per_mp["decode"], crop_decode_s_per_mp=t_cpp / crop_mp,
               decode_plain_s_per_mp=t_plain / crop_mp,
               baseline_decode_s_per_mp=per_mp["baseline"],
               write_s_per_view=float(np.median(times["write"])),
               lossless_fixtures=len(fixtures), lossless=lossless,
               arith_fixtures=len(arith_fixtures), arith=arith,
               phase_s=time.perf_counter() - t_phase)
    log("[progressive] " + json.dumps(res))
    return res, views


def lossless_row(port, predictor, u8, root, i, tmpdir):
    """Rendered view `i` (`u8`) as a lossless JPEG of `predictor` (RGB, point
    transform 0): `read_jpeg` must give the rendered bytes; its CROP_9F
    centre, written the same way, decodes through `read_jpeg` and
    `read_jpeg_plain` to the crop itself -> the row's figures and the
    file's path."""
    path = os.path.join(root, f"{i:03d}_lossless_p{predictor}.jpg")
    data, t_write = timed(port.jpeg.encode_jpeg_lossless, u8, predictor)
    with open(path, "wb") as fh:
        fh.write(data)
    got, t = timed(port.jpeg.read_jpeg, path)
    if not np.array_equal(got, u8):
        raise AssertionError(f"view {i}'s lossless JPEG (predictor {predictor}) decodes to "
                             "other bytes than were rendered")
    crop = centre_crop(u8)
    cpath = os.path.join(tmpdir, f"lossless_crop_p{predictor}.jpg")
    with open(cpath, "wb") as fh:
        fh.write(port.jpeg.encode_jpeg_lossless(crop, predictor))
    small, t_cpp = timed(port.jpeg.read_jpeg, cpath)
    plain, t_plain = timed(port.jpeg.read_jpeg_plain, cpath)
    if not (np.array_equal(small, crop) and np.array_equal(plain, crop)):
        raise AssertionError(f"the lossless crop (predictor {predictor}) decodes to other "
                             "bytes than were written")
    return dict(path=path, view=i, bytes=len(data),
                decode_s_per_mp=t / (u8.shape[0] * u8.shape[1] / 1e6),
                plain_vs_cpp=t_plain / t_cpp, write_s=t_write)


def arith_row(port, kind, u8, base, huffman, root, i, tmpdir):
    """Rendered view `i` (`u8`) as an arithmetic-coded JPEG of `kind` (SOF9,
    or SOF10 in the 10-scan progression), the coefficients of its Huffman
    file `huffman` (quality 90, 4:2:0; baseline for SOF9, progressive for
    SOF10): `read_jpeg` must give `base`, phase 9's baseline decode of the
    view; its ARITH_CROP_9B centre, written the same way, decodes through
    `read_jpeg` and `read_jpeg_plain` to the bytes of the crop's Huffman
    file -> the row's figures and the file's path."""
    progressive = kind == "sof10"
    path = os.path.join(root, f"{i:03d}_arith_{kind}.jpg")
    _, t_write = timed(port.jpeg.write_jpeg, path, u8, EVAL_QUALITY, "4:2:0", progressive,
                       False, True)
    got, t = timed(port.jpeg.read_jpeg, path)
    if not np.array_equal(got, base):
        raise AssertionError(f"view {i}'s {kind} JPEG decodes to other bytes than phase 9's "
                             "baseline file of the same coefficients")
    crop = centre_crop(u8, ARITH_CROP_9B)
    cpath = os.path.join(tmpdir, f"arith_crop_{kind}.jpg")
    port.jpeg.write_jpeg(cpath, crop, EVAL_QUALITY, "4:2:0", progressive, False, True)
    want = port.jpeg.decode_jpeg(port.jpeg.encode_jpeg(crop, EVAL_QUALITY, "4:2:0",
                                                       progressive))
    small, t_cpp = timed(port.jpeg.read_jpeg, cpath)
    plain, t_plain = timed(port.jpeg.read_jpeg_plain, cpath)
    if not (np.array_equal(small, want) and np.array_equal(plain, want)):
        raise AssertionError(f"the {kind} crop decodes to other bytes than its Huffman file")
    size = os.path.getsize(path)
    crop_mp = ARITH_CROP_9B[0] * ARITH_CROP_9B[1] / 1e6
    return dict(path=path, view=i, bytes=size, bytes_vs_huffman=size / os.path.getsize(huffman),
                decode_s_per_mp=t / (u8.shape[0] * u8.shape[1] / 1e6),
                crop_plain_s_per_mp=t_plain / crop_mp, plain_vs_cpp=t_plain / t_cpp,
                write_s=t_write)


# ------------------------------------------------------------------ phase 9c

def fixed_palette(levels):
    """The palette of a regular grid of `levels` (R, G, B) steps, R slowest
    -> (R * G * B, 3) uint8."""
    axes = [np.rint(np.arange(n) * 255.0 / (n - 1)).astype(np.uint8) for n in levels]
    grid = np.meshgrid(*axes, indexing="ij")
    return np.stack([g.ravel() for g in grid], 1)


def quantize(img, levels):
    """(H, W, 3) uint8 -> uint8 indices into `fixed_palette(levels)` of 256
    colours or fewer (`quantize_wide`)."""
    return quantize_wide(img, levels).astype(np.uint8)


def quantize_wide(img, levels):
    """(H, W, 3) uint8 -> int32 indices into `fixed_palette(levels)`: each
    channel rounded to its nearest step."""
    q = [np.rint(img[..., k].astype(np.float32) * ((n - 1) / 255.0)).astype(np.int32)
         for k, n in enumerate(levels)]
    return (q[0] * levels[1] + q[1]) * levels[2] + q[2]


def write_9c_view(port, kind, path, img, interlace):
    """View `img` written as `kind` -> (the array `read_image` must give,
    the writer's s)."""
    if kind.startswith("tiff"):
        pixels = img.astype(np.uint16) * 257 if kind.startswith("tiff16") else img
        kw = (dict(compression="packbits") if kind == "tiff_packbits" else
              dict(compression="lzw", predictor=2 if kind.endswith("p2") else 1))
        _, t = timed(lambda: port.tiff.write_tiff(path, pixels, **kw))
        return img, t
    levels = LEVELS_16 if kind == "bmp_rle4" else LEVELS_256
    pal, idx = fixed_palette(levels), quantize(img, levels)
    if kind == "gif":
        _, t = timed(lambda: port.gif.write_gif(path, idx, pal, interlace=interlace))
    else:
        _, t = timed(lambda: port.bmp.write_bmp(path, idx, palette=pal,
                                                bits=4 if kind == "bmp_rle4" else 8,
                                                rle=True))
    return pal[idx], t


def decode_plain_9c(port, kind, data):
    if kind.startswith("tiff"):
        return port.tiff.decode_tiff_plain(data)
    if kind == "gif":
        return port.gif.decode_gif_plain(data)
    return port.bmp.decode_bmp_plain(data)


def both_raise(port, kind, data, words):
    """`data` through `read_image` and the plain decoder of `kind`: the same
    ValueError naming `words` -> its message."""
    msgs = []
    with tempfile.NamedTemporaryFile(suffix=".bad") as fh:
        fh.write(data)
        fh.flush()
        for read in (port.png.read_image, lambda p: decode_plain_9c(
                port, kind, open(p, "rb").read())):
            try:
                read(fh.name)
            except ValueError as err:
                msgs.append(str(err).replace(fh.name, "<file>").replace("<bytes>", "<file>"))
            else:
                raise AssertionError(f"a damaged {kind} file decoded")
    if msgs[0] != msgs[1] or words not in msgs[0]:
        raise AssertionError(f"damaged {kind}: {msgs}")
    return msgs[0]


def phase_formats(torch, port, scene, tmpdir):
    """Phase 9c (see the module docstring) on phase 9's `scene` ->
    (results, {view: (file, None or its decode)} for the shared training)."""
    t_phase = time.perf_counter()
    root = os.path.join(tmpdir, "formats_data")
    os.makedirs(root)
    kinds = [k for k, n in FORMATS_9C for _ in range(n)]
    assert len(kinds) == len(scene["cams"]), (len(kinds), len(scene["cams"]))
    names = [f"{i:03d}" + (".tif" if kind.startswith("tiff") else "." + kind[:3])
             for i, kind in enumerate(kinds)]
    stats = {k: {"decode": [], "write": [], "bytes": []} for k, _ in FORMATS_9C}
    expected, plain_done, seen = {}, {}, {}
    for i, kind in enumerate(kinds):
        base = port.jpeg.read_jpeg(os.path.join(scene["root"], "images", f"{i:03d}.jpg"))
        path = os.path.join(root, names[i])
        seen[kind] = seen.get(kind, 0) + 1
        want, t = write_9c_view(port, kind, path, base, interlace=seen[kind] % 2 == 0)
        stats[kind]["write"].append(t)
        stats[kind]["bytes"].append(os.path.getsize(path))
        got, t = timed(port.png.read_image, path)
        stats[kind]["decode"].append(t)
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"{names[i]} ({kind}) decodes to other bytes than "
                                 "were written")
        expected[i] = (path, None if np.array_equal(got, base) else got)
        if kind not in plain_done:
            with open(path, "rb") as fh:
                data = fh.read()
            plain, t = timed(decode_plain_9c, port, kind, data)
            if not np.array_equal(plain, got):
                raise AssertionError(f"{names[i]}: the plain {kind} decode differs "
                                     "from the C++ one")
            plain_done[kind] = t
    megapixels = EVAL_WIDTH * EVAL_HEIGHT / 1e6
    by_format = {k: dict(views=len(v["decode"]),
                         decode_s_per_mp=float(np.median(v["decode"])) / megapixels,
                         plain_s_per_mp=plain_done[k] / megapixels,
                         bytes_mean=float(np.mean(v["bytes"])),
                         write_s=float(np.median(v["write"])))
                 for k, v in stats.items()}
    first = {k: kinds.index(k) for k, _ in FORMATS_9C}
    with open(os.path.join(root, names[first["tiff_lzw_p2"]]), "rb") as fh:
        lzw_tiff = fh.read()
    with open(os.path.join(root, names[first["gif"]]), "rb") as fh:
        gif_file = fh.read()
    at = 13 + 3 * 256 + 10 + 2 + 3         # the GIF's fourth byte of LZW data
    damaged = {
        "tiff": both_raise(port, "tiff_lzw_p2", lzw_tiff[:len(lzw_tiff) - 777],
                           "cut short"),
        "gif": both_raise(port, "gif", gif_file[:at] + b"\xff\xff\xff" + gif_file[at + 3:],
                          "past the table"),
    }
    for kind, r in by_format.items():
        log(f"[formats] {kind}: {r['views']} views at {EVAL_WIDTH}x{EVAL_HEIGHT}, "
            f"{r['bytes_mean']:.0f} bytes each; decode {r['decode_s_per_mp']:.4f} s/MP "
            f"(plain {r['plain_s_per_mp']:.4f}); write {r['write_s']:.3f} s a view")
    log(f"[formats] every view decoded to the bytes written; damaged files raise "
        f"through both decoders: {json.dumps(damaged)}")

    res = dict(formats=by_format, damaged=damaged, phase_s=time.perf_counter() - t_phase)
    log("[formats] " + json.dumps(res))
    return res, expected


# ------------------------------------------------------------------ phase 9d

def webp_fixtures(port):
    """Phase 9d's fixtures -> {name: "raises" or the C++ decode's s}."""
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "webp")
    with open(os.path.join(here, "digests.json")) as fh:
        table = json.load(fh)
    if len(table) < 12:
        raise AssertionError(f"{here}: {len(table)} WebP fixtures")

    def sha(*arrays):
        h = hashlib.sha256()
        for a in arrays:
            h.update(np.ascontiguousarray(a).tobytes())
        return h.hexdigest()
    out = {}
    for name, want in sorted(table.items()):
        path = os.path.join(here, name)
        with open(path, "rb") as fh:
            data = fh.read()
        if want["rgb"] == "raises":
            for decode in (port.webp.decode_webp, port.webp.decode_webp_plain):
                try:
                    decode(data)
                except ValueError as err:
                    if "cut short" not in str(err):
                        raise
                else:
                    raise AssertionError(f"{name} decoded through {decode.__name__}; "
                                         "the reference raises")
            out[name] = "raises"
            continue
        rgb, t = timed(port.png.read_image, path)
        frame = port.webp.frame_of(data)
        planes = port.webp.decode_vp8(frame)[:3]
        plain = port.webp.vp8_decode_plain(frame)[:3]
        if sha(rgb) != want["rgb"] or sha(*planes) != want["yuv"]:
            raise AssertionError(f"{name}: the C++ decode differs from the recorded digest")
        if sha(*plain) != want["yuv"] or sha(port.webp.yuv_to_rgb_plain(*plain)) != want["rgb"]:
            raise AssertionError(f"{name}: the plain decode differs from the recorded digest")
        out[name] = t
    return out


def psnr_u8(a, b) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * math.log10(255.0 ** 2 / mse)


def phase_webp(torch, port, scene, tmpdir):
    """Phase 9d (see the module docstring) on phase 9's `scene` ->
    (results, {view: (file, its decode)} for the shared training)."""
    t_phase = time.perf_counter()
    fixtures = webp_fixtures(port)
    log(f"[webp] {len(fixtures)} fixtures decode to their recorded digests through the "
        f"C++ and the plain version ({sum(v == 'raises' for v in fixtures.values())} raise "
        "\"cut short\" through both, as the reference does)")
    root = os.path.join(tmpdir, "webp_data")
    os.makedirs(root)
    rows = [r for r, n, _, _ in WEBP_9D for _ in range(n)]
    assert len(rows) == len(scene["cams"]), (len(rows), len(scene["cams"]))
    settings = {r: kw for r, _, kw, _ in WEBP_9D}
    stats = {r: {"decode": [], "write": [], "bytes": [], "psnr": [], "skip": [],
                 "cat6": []} for r, _, _, _ in WEBP_9D}
    decoded, plain_done = {}, {}
    n_mb = -(-EVAL_WIDTH // 16) * -(-EVAL_HEIGHT // 16)
    for i, row in enumerate(rows):
        base = port.jpeg.read_jpeg(os.path.join(scene["root"], "images", f"{i:03d}.jpg"))
        path = os.path.join(root, f"{i:03d}.webp")
        planes, t = timed(lambda: port.webp.write_webp(path, base, **settings[row]))
        stats[row]["write"].append(t)
        stats[row]["bytes"].append(os.path.getsize(path))
        got, t = timed(port.png.read_image, path)
        stats[row]["decode"].append(t)
        with open(path, "rb") as fh:
            data = fh.read()
        y, u, v, info = port.webp.decode_vp8(port.webp.frame_of(data))
        if not all(np.array_equal(a, b) for a, b in zip((y, u, v), planes)):
            raise AssertionError(f"view {i} ({row}): the decoded planes differ from the "
                                 "writer's reconstruction")
        if not np.array_equal(got, port.webp.yuv_to_rgb(*planes)):
            raise AssertionError(f"view {i} ({row}): read_image differs from gm_vp8_rgb of "
                                 "the writer's planes")
        info = dict(zip(port.webp.STATS, info.tolist()))
        stats[row]["skip"].append(info["skip"] / n_mb)
        stats[row]["cat6"].append(info["token10"])
        stats[row]["psnr"].append(psnr_u8(got, base))
        decoded[i] = (path, got)
        if row not in plain_done:
            small = port.resample.resize(base, WEBP_PLAIN_SIZE)
            sdata, _ = port.webp.encode_webp(small, **settings[row])
            cpp, t_cpp = timed(port.webp.decode_webp, sdata)
            plain, t_plain = timed(port.webp.decode_webp_plain, sdata)
            if not np.array_equal(cpp, plain):
                raise AssertionError(f"{row}: the plain decode of a {WEBP_PLAIN_SIZE} view "
                                     "differs from the C++ one")
            plain_done[row] = (t_cpp, t_plain)
    megapixels = EVAL_WIDTH * EVAL_HEIGHT / 1e6
    small_mp = WEBP_PLAIN_SIZE[0] * WEBP_PLAIN_SIZE[1] / 1e6
    by_row = {}
    for row, _, _, bar in WEBP_9D:
        st = stats[row]
        by_row[row] = dict(
            views=len(st["decode"]),
            decode_s_per_mp=float(np.median(st["decode"])) / megapixels,
            small_decode_s_per_mp=plain_done[row][0] / small_mp,
            plain_s_per_mp=plain_done[row][1] / small_mp,
            bytes_mean=float(np.mean(st["bytes"])), write_s=float(np.median(st["write"])),
            psnr_min=float(np.min(st["psnr"])), psnr_mean=float(np.mean(st["psnr"])),
            psnr_bar=bar, skip_share=float(np.mean(st["skip"])),
            cat6_tokens=int(np.sum(st["cat6"])))
        if by_row[row]["psnr_min"] < bar:
            raise AssertionError(f"{row}: PSNR {by_row[row]['psnr_min']:.2f} dB against the "
                                 f"views written, under its bound {bar} dB")
    if by_row["4seg_sharp5_deltas_8parts_q4"]["cat6_tokens"] == 0:
        raise AssertionError("quantizer 4 wrote no DCT_CAT6 token")
    if by_row["unfiltered_q110"]["skip_share"] == 0:
        raise AssertionError("quantizer 110 skipped no macroblock")
    for row, r in by_row.items():
        log(f"[webp] {row}: {r['views']} views at {EVAL_WIDTH}x{EVAL_HEIGHT}, "
            f"{r['bytes_mean']:.0f} bytes each, PSNR min {r['psnr_min']:.2f} dB (bound "
            f"{r['psnr_bar']}), skipped {r['skip_share']:.3f}; decode "
            f"{r['decode_s_per_mp']:.4f} s/MP; at {WEBP_PLAIN_SIZE[0]}x{WEBP_PLAIN_SIZE[1]} "
            f"{r['small_decode_s_per_mp']:.4f} (plain {r['plain_s_per_mp']:.4f}); write "
            f"{r['write_s']:.3f} s a view")

    res = dict(rows=by_row, fixtures=len(fixtures), phase_s=time.perf_counter() - t_phase)
    log("[webp] " + json.dumps(res))
    return res, decoded


def webp_rgba_fixtures(port):
    """Phase 9e's fixtures (`tests/data/webp/rgba/`) -> {name: "raises" or the
    C++ decode's s}."""
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "webp",
                        "rgba")
    with open(os.path.join(here, "digests.json")) as fh:
        table = json.load(fh)
    if len(table) < 15:
        raise AssertionError(f"{here}: {len(table)} WebP fixtures")

    def sha(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()
    out = {}
    for name, want in sorted(table.items()):
        path = os.path.join(here, name)
        with open(path, "rb") as fh:
            data = fh.read()
        if want["array"] == "raises":
            for decode in (port.webp.decode_webp, port.webp.decode_webp_plain):
                try:
                    decode(data)
                except ValueError as err:
                    if "cut short" not in str(err):
                        raise
                else:
                    raise AssertionError(f"{name} decoded through {decode.__name__}; "
                                         "the reference raises")
            out[name] = "raises"
            continue
        got, t = timed(port.png.read_image, path)
        if sha(got) != want["array"] or list(got.shape) != want["shape"]:
            raise AssertionError(f"{name}: the C++ decode differs from the recorded digest")
        if sha(port.webp.decode_webp_plain(data)) != want["array"]:
            raise AssertionError(f"{name}: the plain decode differs from the recorded digest")
        out[name] = t
    return out


def view_9e(port, row, kw, rgba, other, path):
    """One view of a phase-9e row written to `path` -> (what `read_image`
    must give, write s). A lossy view's colour is the writer's planes
    through the plain YUV -> RGB, so the C++ decode is held to numpy."""
    t0 = time.perf_counter()
    if row.startswith("animation"):
        h, w = rgba.shape[:2]
        canvas = (w + ANIM_OFFSET[0], h + ANIM_OFFSET[1])
        dec = port.webp.write_webp_animation(path, [rgba, other], canvas,
                                             offsets=[ANIM_OFFSET, (0, 0)], **kw)[0]
    else:
        dec = port.webp.write_webp(path, rgba, **kw)
    t = time.perf_counter() - t0
    if kw.get("lossless"):
        return dec, t
    want = np.concatenate([port.webp.yuv_to_rgb_plain(*dec[:3]), dec[3][..., None]], -1)
    if row.startswith("animation"):
        canvas = np.zeros((h + ANIM_OFFSET[1], w + ANIM_OFFSET[0], 4), np.uint8)
        canvas[ANIM_OFFSET[1]:, ANIM_OFFSET[0]:] = want
        want = canvas
    return want, t


def training_dataset(torch, port, argv):
    """The `DeviceDataset` `cli.train_mesh` builds from `argv` (its flags,
    `Scene` with the run's shuffle seed, `from_cameras` on the card), with
    no trainer -> (dataset, its seconds)."""
    t0 = time.perf_counter()
    args, _ = port.cli_common.base_parser("").parse_known_args(argv)
    model = port.config.extract(port.config.ModelParams, args)
    seed = port.config.extract(port.config.RuntimeParams, args).seed
    scene = port.scene.Scene(model, seed=seed)
    ds = port.trainer.DeviceDataset.from_cameras(scene.train_cameras, device="cuda")
    torch.cuda.synchronize()
    return ds, time.perf_counter() - t0


def phase_webp_alpha(torch, port, p8, sched, jpeg_s_per_mp, tmpdir):
    """Phase 9e (see the module docstring) on phase 8's config-2 set `p8` ->
    results."""
    t_phase = time.perf_counter()
    fixtures = webp_rgba_fixtures(port)
    log(f"[webp9e] {len(fixtures)} fixtures decode to their recorded digests through the "
        f"C++ and the plain version ({sum(v == 'raises' for v in fixtures.values())} raise "
        "\"cut short\" through both, as the reference does)")
    src = p8["root"]
    views = sorted(n for n in os.listdir(os.path.join(src, "views")) if n.endswith(".png"))
    rgbas = [port.png.read_png(os.path.join(src, "views", n)) for n in views]
    assert all(r.shape == (PIPE_SIZE, PIPE_SIZE, 4) for r in rgbas), rgbas[0].shape
    levels = LEVELS_16[:1] + (2, 2)
    stats = {}
    root = os.path.join(tmpdir, "webp9e")
    for row, n, kw in WEBP_9E:
        st = stats[row] = {"decode": [], "write": [], "bytes": []}
        d = os.path.join(root, row)
        os.makedirs(d)
        for i in range(len(rgbas) if n is None else n):
            rgba = rgbas[i]
            if "quantized" in row:
                q = fixed_palette(levels)[quantize(rgba[..., :3], levels)]
                rgba = np.concatenate([q, np.where(rgba[..., 3:] >= 128, 255, 0).astype(
                    np.uint8)], -1)
                assert len(np.unique(port.vp8l.rgba_to_argb(rgba))) <= 16
            path = os.path.join(d, views[i].replace(".png", ".webp"))
            want, t = view_9e(port, row, kw, rgba, rgbas[(i + 1) % len(rgbas)], path)
            st["write"].append(t)
            st["bytes"].append(os.path.getsize(path))
            for _ in range(DECODES_9E):
                got, t = timed(port.png.read_image, path)
                st["decode"].append(t)
            if not np.array_equal(got, want):
                raise AssertionError(f"{row} view {i}: read_image differs from what was "
                                     "written (lossless: the RGBA; lossy: the writer's "
                                     "reconstruction and the exact alpha)")
            if kw.get("lossless") and "quantized" not in row and not np.array_equal(got, rgbas[i]):
                raise AssertionError(f"{row} view {i}: not phase 8's RGBA")
        c0 = (PIPE_SIZE - WEBP_9E_PLAIN) // 2
        crop = np.ascontiguousarray(rgbas[1][c0:c0 + WEBP_9E_PLAIN, c0:c0 + WEBP_9E_PLAIN])
        if "quantized" in row:
            q = fixed_palette(levels)[quantize(crop[..., :3], levels)]
            crop = np.concatenate([q, np.where(crop[..., 3:] >= 128, 255, 0).astype(
                np.uint8)], -1)
        small = os.path.join(d, "small.webp")
        view_9e(port, row, kw, crop, crop[::-1].copy(), small)
        with open(small, "rb") as fh:
            data = fh.read()
        cpp, t_cpp = timed(port.webp.decode_webp, data)
        plain, t_plain = timed(port.webp.decode_webp_plain, data)
        if not np.array_equal(cpp, plain):
            raise AssertionError(f"{row}: the plain decode of a {WEBP_9E_PLAIN}^2 view "
                                 "differs from the C++ one")
        st["small"] = (t_cpp, t_plain)
    megapixels = PIPE_SIZE * PIPE_SIZE / 1e6
    by_row = {}
    for row, _, _ in WEBP_9E:
        st = stats[row]
        dec = float(np.median(st["decode"])) / megapixels
        by_row[row] = dict(views=len(st["bytes"]), decodes=len(st["decode"]),
                           decode_s_per_mp=dec,
                           decode_vs_baseline_jpeg=dec / jpeg_s_per_mp,
                           plain_vs_cpp=st["small"][1] / st["small"][0],
                           bytes_mean=float(np.mean(st["bytes"])),
                           write_s=float(np.median(st["write"])))
        r = by_row[row]
        log(f"[webp9e] {row}: {r['views']} views at {PIPE_SIZE}x{PIPE_SIZE}, "
            f"{r['bytes_mean']:.0f} bytes each; decode {r['decode_s_per_mp']:.4f} s/MP "
            f"(the median of {r['decodes']}) "
            f"({r['decode_vs_baseline_jpeg']:.2f}x phase 9's baseline JPEG); plain / C++ at "
            f"{WEBP_9E_PLAIN}^2 {r['plain_vs_cpp']:.0f}; write {r['write_s']:.3f} s a view")

    # the lossless row as a Blender set: phase 8's transforms, .webp views
    data = os.path.join(tmpdir, "blender_webp")
    os.makedirs(os.path.join(data, "views"))
    for n in views:
        name = n.replace(".png", ".webp")
        shutil.copy(os.path.join(root, WEBP_9E[0][0], name), os.path.join(data, "views", name))
    for split in ("train", "test"):
        with open(os.path.join(src, f"transforms_{split}.json")) as fh:
            meta = json.load(fh)
        for fr in meta["frames"]:
            fr["file_path"] += ".webp"
        with open(os.path.join(data, f"transforms_{split}.json"), "w") as fh:
            json.dump(meta, fh)
    ds, load_s = training_dataset(torch, port, ["-s", data, "--eval", *sched])
    for key, ref in (("images", p8["images"]), ("masks", p8["masks"]),
                     ("campos", p8["campos"])):
        if not torch.equal(getattr(ds, key).cpu(), ref):
            raise AssertionError(f"the WebP Blender set's training {key} differ from phase 8's")
    res = dict(rows=by_row, fixtures=len(fixtures), train_views=int(ds.images.shape[0]),
               load_s=load_s, phase_s=time.perf_counter() - t_phase)
    log("[webp9e] " + json.dumps(res))
    return res


# ------------------------------------------------------------------ phase 9f

def tiff_fixtures(port):
    """Phase 9f's fixtures -> {name: the C++ decode's s}: each gives its
    recorded digest and shape through `read_image` and the plain route."""
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "tiff")
    with open(os.path.join(here, "digests.json")) as fh:
        table = json.load(fh)
    if len(table) < 12:
        raise AssertionError(f"{here}: {len(table)} TIFF and CMYK JPEG fixtures")
    out = {}
    for name, want in sorted(table.items()):
        path = os.path.join(here, name)
        with open(path, "rb") as fh:
            data = fh.read()
        got, t = timed(port.png.read_image, path)
        plain = (port.tiff.decode_tiff_plain(data) if name.endswith(".tif") else
                 port.jpeg.decode_jpeg(data, native=False))
        for route, a in (("C++", got), ("plain", plain)):
            if (hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest() != want["array"]
                    or list(a.shape) != want["shape"]):
                raise AssertionError(f"{name}: the {route} decode differs from the recorded "
                                     "digest")
        out[name] = t
    return out


def cmyk_of(rgb):
    """A view's CMYK separation (the writer's input for the CMYK rows): K =
    255 - max(R, G, B), C, M, Y the rest of each channel's ink."""
    top = rgb.max(-1, keepdims=True)
    return np.concatenate([top - rgb, 255 - top], -1).astype(np.uint8)


def write_9f_view(port, row, kw, path, img):
    """View `img` written as row `row` -> (what `read_image` must give, or
    None where the plain route decides it; write s)."""
    if row.startswith(("cmyk_jpeg", "ycck_jpeg")):
        _, t = timed(lambda: port.jpeg.write_jpeg(path, cmyk_of(img), **kw))
        return None, t
    pixels = cmyk_of(img) if row.startswith("cmyk") else (
        img.astype(np.uint16) * 257 if "tiff16" in row else img)
    _, t = timed(lambda: port.tiff.write_tiff(path, pixels, **kw))
    if row.startswith("jpeg"):
        return None, t
    return (port.jpeg.cmyk_to_rgb(pixels) if row.startswith("cmyk") else img), t


def decode_plain_9f(port, path):
    with open(path, "rb") as fh:
        data = fh.read()
    return (port.jpeg.decode_jpeg(data, path, native=False) if path.endswith(".jpg") else
            port.tiff.decode_tiff_plain(data, path))


def phase_tiff_layouts(torch, port, scene, jpeg_s_per_mp, tmpdir):
    """Phase 9f (see the module docstring) on phase 9's `scene` ->
    (results, {view: (file, None or its decode)} for the shared training)."""
    t_phase = time.perf_counter()
    fixtures = tiff_fixtures(port)
    zstd_fixtures = fixture_digests(port, "tiff_zstd", decode_plain_9f, "Zstandard TIFF",
                                    least=40)
    log(f"[tiff9f] {len(fixtures)} fixtures and {len(zstd_fixtures)} Zstandard ones decode "
        "to their recorded digests through the C++ and the plain route (the Zstandard "
        "forms PIL fails on raise alike)")
    root = os.path.join(tmpdir, "tiff9f_data")
    os.makedirs(root)
    rows = [(r, kw) for r, n, kw in LAYOUTS_9F for _ in range(n)]
    assert len(rows) == len(scene["cams"]), (len(rows), len(scene["cams"]))
    stats = {r: {"decode": [], "write": [], "bytes": [], "jpeg_bytes": [], "deflate_bytes": []}
             for r, _, _ in LAYOUTS_9F}
    expected, small = {}, {}
    for i, (row, kw) in enumerate(rows):
        src = os.path.join(scene["root"], "images", f"{i:03d}.jpg")
        base = port.jpeg.read_jpeg(src)
        path = os.path.join(root, f"{i:03d}" + (
            ".jpg" if row.endswith(("jpeg_adobe", "jpeg_420")) else ".tif"))
        want, t = write_9f_view(port, row, kw, path, base)
        st = stats[row]
        st["write"].append(t)
        st["bytes"].append(os.path.getsize(path))
        st["jpeg_bytes"].append(os.path.getsize(src))
        if "zstd" in row:               # the same view as Deflate, the row's settings
            dpath = os.path.join(tmpdir, "tiff9f_deflate.tif")
            write_9f_view(port, row, dict(kw, compression="deflate"), dpath, base)
            st["deflate_bytes"].append(os.path.getsize(dpath))
        got, t = timed(port.png.read_image, path)
        st["decode"].append(t)
        if want is None:                # lossy: the plain route decides
            want = decode_plain_9f(port, path)
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"view {i} ({row}) decodes to other bytes than "
                                 "it should (lossless: the samples written; JPEG: the "
                                 "plain route's)")
        expected[i] = (path, None if np.array_equal(got, base) else got)
        if row not in small:
            crop = centre_crop(base)
            cpath = os.path.join(tmpdir, "tiff9f_crop" + os.path.splitext(path)[1])
            write_9f_view(port, row, kw, cpath, crop)
            cpp, t_cpp = timed(port.png.read_image, cpath)
            plain, t_plain = timed(decode_plain_9f, port, cpath)
            if cpp.shape != plain.shape or not np.array_equal(cpp, plain):
                raise AssertionError(f"{row}: the plain decode of a {CROP_9F} crop differs "
                                     "from the C++ one")
            small[row] = (t_cpp, t_plain)
    megapixels = EVAL_WIDTH * EVAL_HEIGHT / 1e6
    by_row = {}
    for row, _, _ in LAYOUTS_9F:
        st = stats[row]
        dec = float(np.median(st["decode"])) / megapixels
        by_row[row] = dict(views=len(st["bytes"]), decode_s_per_mp=dec,
                           decode_vs_baseline_jpeg=dec / jpeg_s_per_mp,
                           plain_vs_cpp=small[row][1] / small[row][0],
                           bytes_mean=float(np.mean(st["bytes"])),
                           bytes_vs_baseline_jpeg=float(np.sum(st["bytes"])
                                                        / np.sum(st["jpeg_bytes"])),
                           write_s=float(np.median(st["write"])))
        if st["deflate_bytes"]:
            by_row[row]["bytes_vs_deflate"] = float(np.sum(st["bytes"])
                                                    / np.sum(st["deflate_bytes"]))
        r = by_row[row]
        log(f"[tiff9f] {row}: {r['views']} views at {EVAL_WIDTH}x{EVAL_HEIGHT}, "
            f"{r['bytes_mean']:.0f} bytes each ({r['bytes_vs_baseline_jpeg']:.2f}x phase 9's "
            f"JPEG files of the same views); decode {r['decode_s_per_mp']:.4f} s/MP "
            f"({r['decode_vs_baseline_jpeg']:.2f}x phase 9's baseline JPEG); plain / C++ at "
            f"{CROP_9F[0]}x{CROP_9F[1]} {r['plain_vs_cpp']:.1f}; write {r['write_s']:.3f} s "
            "a view" + (f"; bytes {r['bytes_vs_deflate']:.3f}x the Deflate file of the same "
                        "settings" if "bytes_vs_deflate" in r else ""))

    res = dict(rows=by_row, fixtures=len(fixtures) + len(zstd_fixtures),
               phase_s=time.perf_counter() - t_phase)
    log("[tiff9f] " + json.dumps(res))
    return res, expected


# ------------------------------------------- phases 9g, 9i, 9j, 9k, 9l: shared

def fixture_digests(port, folder, decode_plain, what, each=None, exts=None, least=30):
    """The fixtures of `tests/data/<folder>/` (those of the extensions
    `exts`, where given; at least `least`) -> {name: the C++ decode's s}:
    each gives its recorded digest and shape through `read_image` and
    `decode_plain(port, path)`, or, where the record holds no array (a
    form the port refuses), raises the same ValueError through both;
    `each(name, data)`, where given, is then called on each file's bytes."""
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", folder)
    with open(os.path.join(here, "digests.json")) as fh:
        table = json.load(fh)
    if exts is not None:
        table = {k: v for k, v in table.items() if os.path.splitext(k)[1] in exts}
    if len(table) < least:
        raise AssertionError(f"{here}: {len(table)} {what} fixtures")
    out = {}
    for name, want in sorted(table.items()):
        path = os.path.join(here, name)
        if want["array"] is None:
            causes = set()
            for route in (port.png.read_image, lambda p: decode_plain(port, p)):
                try:
                    route(path)
                except ValueError as err:
                    causes.add(str(err))
                else:
                    raise AssertionError(f"{name}: decoded, where the port refuses it")
            if len(causes) != 1:
                raise AssertionError(f"{name}: the two routes refuse it differently: {causes}")
            continue
        got, t = timed(port.png.read_image, path)
        for route, a in (("C++", got), ("plain", decode_plain(port, path))):
            if (hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest() != want["array"]
                    or list(a.shape) != want["shape"]):
                raise AssertionError(f"{name}: the {route} decode differs from the recorded "
                                     "digest")
        out[name] = t
        if each is not None:
            with open(path, "rb") as fh:
                each(name, fh.read())
    return out


def reader_views(port, scene, table, exts, write_view, decode_plain, tag, jpeg_s_per_mp,
                 tmpdir):
    """Phase 9's views written in the rows of `table` ((row, views) in
    turn; a view's file extension `exts[row[:3]]`) by `write_view(port,
    row, path, img)` -> (what `read_image` must give, write s): each read
    back by `read_image` to the samples written, the CROP_9F centre of one
    view a row through `decode_plain(port, path)` to the C++'s bytes ->
    ({row: its rates}, {view: (file, None or its decode)} for the shared
    training)."""
    root = os.path.join(tmpdir, f"{tag}_data")
    os.makedirs(root)
    rows = [r for r, n in table for _ in range(n)]
    assert len(rows) == len(scene["cams"]), (len(rows), len(scene["cams"]))
    stats = {r: {"decode": [], "write": [], "bytes": [], "jpeg_bytes": []} for r, _ in table}
    expected, small = {}, {}
    for i, row in enumerate(rows):
        src = os.path.join(scene["root"], "images", f"{i:03d}.jpg")
        base = port.jpeg.read_jpeg(src)
        path = os.path.join(root, f"{i:03d}" + exts[row[:3]])
        want, t = write_view(port, row, path, base)
        st = stats[row]
        st["write"].append(t)
        st["bytes"].append(os.path.getsize(path))
        st["jpeg_bytes"].append(os.path.getsize(src))
        got, t = timed(port.png.read_image, path)
        st["decode"].append(t)
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"view {i} ({row}) decodes to other bytes than were written")
        expected[i] = (path, None if np.array_equal(got, base) else got)
        if row not in small:
            cpath = os.path.join(tmpdir, f"{tag}_crop" + exts[row[:3]])
            write_view(port, row, cpath, centre_crop(base))
            cpp, t_cpp = timed(port.png.read_image, cpath)
            plain, t_plain = timed(decode_plain, port, cpath)
            if cpp.shape != plain.shape or not np.array_equal(cpp, plain):
                raise AssertionError(f"{row}: the plain decode of a {CROP_9F} crop differs "
                                     "from the C++ one")
            small[row] = (t_cpp, t_plain)
    megapixels = EVAL_WIDTH * EVAL_HEIGHT / 1e6
    by_row = {}
    for row, _ in table:
        st = stats[row]
        dec = float(np.median(st["decode"])) / megapixels
        by_row[row] = dict(views=len(st["bytes"]), decode_s_per_mp=dec,
                           decode_vs_baseline_jpeg=dec / jpeg_s_per_mp,
                           plain_vs_cpp=small[row][1] / small[row][0],
                           bytes_mean=float(np.mean(st["bytes"])),
                           bytes_vs_baseline_jpeg=float(np.sum(st["bytes"])
                                                        / np.sum(st["jpeg_bytes"])),
                           write_s=float(np.median(st["write"])))
        r = by_row[row]
        log(f"[{tag}] {row}: {r['views']} views at {EVAL_WIDTH}x{EVAL_HEIGHT}, "
            f"{r['bytes_mean']:.0f} bytes each ({r['bytes_vs_baseline_jpeg']:.2f}x phase 9's "
            f"JPEG files of the same views); decode {r['decode_s_per_mp']:.4f} s/MP "
            f"({r['decode_vs_baseline_jpeg']:.2f}x phase 9's baseline JPEG); plain / C++ at "
            f"{CROP_9F[0]}x{CROP_9F[1]} {r['plain_vs_cpp']:.1f}; write {r['write_s']:.3f} s "
            "a view")
    return by_row, expected


# ------------------------------------------------------------------ phase 9g

def decode_plain_9g(port, path):
    """A 9g file through the plain route (PNM has one route: no C++)."""
    with open(path, "rb") as fh:
        data = fh.read()
    ext = os.path.splitext(path)[1]
    return {".tga": port.tga.decode_tga_plain, ".qoi": port.qoi.decode_qoi_plain,
            ".sgi": port.sgi.decode_sgi_plain, ".pcx": port.pcx.decode_pcx_plain}.get(
        ext, port.pnm.decode_pnm)(data, path)


def write_9g_view(port, row, path, img):
    """View `img` written as row `row` of RAW_9G -> (what `read_image` must
    give, the writer's s)."""
    t0 = time.perf_counter()
    want = img
    if row.startswith("ppm"):
        port.pnm.write_pnm(path, img, ascii="ascii" in row)
    elif row.startswith("pgm"):                  # the high byte is the view's green
        want = img[..., 1]
        port.pnm.write_pnm(path, want.astype(np.uint16) << 8 | img[..., 0], maxval=65535)
    elif row.endswith(("colormapped_b15", "palette_b15")):
        pal, idx = fixed_palette(LEVELS_256), quantize(img, LEVELS_256)
        want = pal[idx]
        if row.startswith("tga"):
            port.tga.write_tga(path, idx, palette=pal, rle=True)
        else:
            port.pcx.write_pcx(path, idx, palette=pal)
    elif row.startswith("tga"):
        alpha = np.full(img.shape[:2] + (1,), 0 if "0alpha" in row else 255, np.uint8)
        rgba = np.concatenate([img, alpha], -1)
        if row == "tga_raw24_bottom_up":
            port.tga.write_tga(path, img)
        elif row == "tga_raw32_0alpha_b20":
            port.tga.write_tga(path, rgba, alpha_bits=0)
        else:
            want = rgba
            port.tga.write_tga(path, rgba, rle=True, top_down=True)
    elif row.startswith("qoi"):
        if row == "qoi_rgba":
            want = np.concatenate([img, np.full(img.shape[:2] + (1,), 255, np.uint8)], -1)
        port.qoi.write_qoi(path, want)
    elif row == "sgi_rle8":
        port.sgi.write_sgi(path, img, rle=True)
    elif row == "sgi_verbatim16":
        port.sgi.write_sgi(path, img.astype(np.uint16) * 257, bpc=2)
    else:
        port.pcx.write_pcx(path, img)
    return want, time.perf_counter() - t0


def phase_raw_formats(torch, port, scene, jpeg_s_per_mp, tmpdir):
    """Phase 9g (see the module docstring) on phase 9's `scene` ->
    (results, {view: (file, None or its decode)} for the shared training)."""
    t_phase = time.perf_counter()
    fixtures = fixture_digests(port, "raw", decode_plain_9g, "PNM / TGA / QOI / SGI / PCX")
    log(f"[raw9g] {len(fixtures)} fixtures decode to their recorded digests through the "
        "C++ and the plain route")
    exts = {"ppm": ".ppm", "pgm": ".pgm", "tga": ".tga", "qoi": ".qoi", "sgi": ".sgi",
            "pcx": ".pcx"}
    by_row, expected = reader_views(port, scene, RAW_9G, exts, write_9g_view, decode_plain_9g,
                                    "raw9g", jpeg_s_per_mp, tmpdir)
    res = dict(rows=by_row, fixtures=len(fixtures), phase_s=time.perf_counter() - t_phase)
    log("[raw9g] " + json.dumps(res))
    return res, expected


# ------------------------------------------------------------------ phase 9i

def icns_walk(port, name, data, walks):
    """`gm_icns_rle` against its plain walk on each run-length image of an
    ICNS fixture, plain / C++ appended to `walks`."""
    for code, (start, length) in (port.icns.blocks(data).items() if name.endswith(".icns")
                                  else ()):
        side = port.icns.LEGACY_SIZES.get(code)
        if code.endswith(b"32") and length != 3 * side[0] * side[1] + 4 * (code == b"it32"):
            start += 4 * (code == b"it32")
            cpp, t_cpp = timed(port.icns._rle, data[start:], side[0] * side[1])
            plain, t_plain = timed(port.icns._rle_plain, data[start:], side[0] * side[1])
            if cpp[1:] != plain[1:] or not np.array_equal(cpp[0], plain[0]):
                raise AssertionError(f"{name}: gm_icns_rle differs from its plain walk")
            walks.append(t_plain / t_cpp)


def decode_plain_9i(port, path):
    """A 9i file through the plain route."""
    with open(path, "rb") as fh:
        data = fh.read()
    return {".dib": port.bmp.decode_dib_plain, ".ico": port.ico.decode_ico_plain,
            ".cur": port.ico.decode_cur_plain, ".dcx": port.pcx.decode_dcx_plain,
            ".icns": port.icns.decode_icns_plain}[os.path.splitext(path)[1]](data, path)


def mask_9i(h, w):
    """The AND mask of phase 9i's icons: 1 (transparent) outside the
    ellipse inscribed in the view."""
    y, x = np.mgrid[0:h, 0:w]
    return ((x - w / 2) / (w / 2)) ** 2 + ((y - h / 2) / (h / 2)) ** 2 > 1.0


def write_9i_view(port, row, path, img):
    """View `img` written as row `row` of CONTAINERS_9I -> (what
    `read_image` must give, the writer's s)."""
    t0 = time.perf_counter()
    h, w = img.shape[:2]
    mask = mask_9i(h, w)
    masked = np.concatenate([img, np.where(mask, 0, 255).astype(np.uint8)[..., None]], 2)
    rgba = np.concatenate([img, np.where(mask, 96, 255).astype(np.uint8)[..., None]], 2)
    want = img
    if row == "dib_24bit":
        port.bmp.write_dib(path, img)
    elif row == "dib_32bit_bitfields_rgba":
        want = rgba
        port.bmp.write_dib(path, rgba, bitfields=True)
    elif row.startswith("ico_png"):
        want = rgba if row.endswith("rgba") else img
        port.ico.write_ico(path, [dict(img=want, form="png", size=(0, 0))])
    elif row == "ico_bmp_32bit":
        want = rgba
        port.ico.write_ico(path, [dict(img=rgba)])
    elif row == "ico_bmp_24bit_and_mask":
        want = masked
        port.ico.write_ico(path, [dict(img=img, mask=mask)])
    elif row == "ico_bmp_8bit_b15":
        pal, idx = fixed_palette(LEVELS_256), quantize(img, LEVELS_256)
        want = np.concatenate([pal[idx], masked[..., 3:]], 2)
        port.ico.write_ico(path, [dict(img=idx, palette=pal, mask=mask)])
    elif row == "ico_bmp_32bit_zero_alpha_b23":
        want = masked
        zero = np.concatenate([img, np.zeros((h, w, 1), np.uint8)], 2)
        port.ico.write_ico(path, [dict(img=zero, mask=mask)])
    elif row == "cur_24bit":
        port.ico.write_ico(path, [dict(img=img, mask=mask)], cursor=True)
    else:
        port.pcx.write_dcx(path, [img, img[::4, ::4]])
    return want, time.perf_counter() - t0


def phase_container_formats(torch, port, scene, jpeg_s_per_mp, tmpdir):
    """Phase 9i (see the module docstring) on phase 9's `scene` ->
    (results, {view: (file, None or its decode)} for the shared training)."""
    t_phase = time.perf_counter()
    walks = []
    fixtures = fixture_digests(port, "containers", decode_plain_9i,
                               "DIB / ICO / CUR / DCX / ICNS",
                               lambda name, data: icns_walk(port, name, data, walks))
    if not walks:
        raise AssertionError("no ICNS fixture holds a run-length image")
    icns_rle = float(np.median(walks))
    log(f"[cont9i] {len(fixtures)} fixtures decode to their recorded digests through the "
        f"C++ and the plain route; ICNS run-length walk plain / C++ {icns_rle:.1f}")
    exts = {k: "." + k for k in ("dib", "ico", "cur", "dcx")}
    by_row, expected = reader_views(port, scene, CONTAINERS_9I, exts, write_9i_view,
                                    decode_plain_9i, "cont9i", jpeg_s_per_mp, tmpdir)
    res = dict(rows=by_row, fixtures=len(fixtures), icns_rle_plain_vs_cpp=icns_rle,
               phase_s=time.perf_counter() - t_phase)
    log("[cont9i] " + json.dumps(res))
    return res, expected


# ------------------------------------------------------------------ phase 9j

RLE_TEXT_PLAIN = {".ras": "sun", ".msp": "msp", ".psd": "psd", ".xbm": "xbm", ".xpm": "xpm"}


def decode_plain_9j(port, path):
    """A 9j file through the plain route (XBM and XPM have one route: no
    C++)."""
    with open(path, "rb") as fh:
        data = fh.read()
    name = RLE_TEXT_PLAIN[os.path.splitext(path)[1]]
    mod = getattr(port, name)
    return getattr(mod, f"decode_{name}_plain", getattr(mod, f"decode_{name}"))(data, path)


def walks_9j(port, name, data, walks):
    """`gm_sun_rle` / `gm_msp_rle` against their plain walks on a fixture
    that holds a byte-encoded Sun raster or MSP v2 rows, plain / C++
    appended to `walks[ext]`."""
    ext = os.path.splitext(name)[1]
    if ext == ".ras" and port.sun.header(data)[3] == 2:
        w, h, depth, _, cmap = port.sun.header(data)
        args = (data[32 + len(cmap):], port.sun.stride(w, depth) * h)
        walk, plain = port.sun._rle, port.sun._rle_plain
    elif ext == ".msp" and data[:4] == b"LinS":
        w, h, _ = port.msp.header(data)
        args = (data[32:], h, (w + 7) // 8)
        walk, plain = port.msp._rle, port.msp._rle_plain
    else:
        return
    got, t_cpp = timed(walk, *args)
    want, t_plain = timed(plain, *args)
    same = (np.array_equal(got, want) if ext == ".ras"
            else got[1:] == want[1:] and np.array_equal(got[0], want[0]))
    if not same:
        raise AssertionError(f"{name}: the C++ walk differs from its plain walk")
    walks[ext].append(t_plain / t_cpp)


def write_9j_view(port, row, path, img):
    """View `img` written as row `row` of RLE_TEXT_9J -> (what `read_image`
    must give, the writer's s)."""
    t0 = time.perf_counter()
    want = img
    ink = img[..., 1] > 128
    if row.startswith(("msp", "xbm")):
        want = ink * np.uint8(255)
    if row == "sun_raw24_bgr":
        port.sun.write_sun(path, img)
    elif row == "sun_rle24_bgr":
        port.sun.write_sun(path, img, rle=True)
    elif row == "sun_rle8_colormap_b15":
        pal, idx = fixed_palette(LEVELS_256), quantize(img, LEVELS_256)
        want = pal[idx]
        port.sun.write_sun(path, idx, colormap=pal, rle=True)
    elif row.startswith("msp"):
        port.msp.write_msp(path, ink, version=1 if row.startswith("msp_v1") else 2)
    elif row == "xbm_b16":
        port.xbm.write_xbm(path, ink)
    elif row.startswith("xpm"):
        levels = LEVELS_256 if row == "xpm_palette_256_b15" else LEVELS_XPM_RGB
        pal, idx = fixed_palette(levels), quantize_wide(img, levels)
        want = pal[idx]
        port.xpm.write_xpm(path, idx, palette=pal, cpp=2)
    elif row == "psd_packbits_cmyk_b14":
        cmyk = cmyk_of(img)
        want = port.jpeg.cmyk_to_rgb(cmyk)
        port.psd.write_psd(path, cmyk, mode=4, packbits=True)
    else:
        port.psd.write_psd(path, img, packbits=row == "psd_packbits_rgb")
    return want, time.perf_counter() - t0


def phase_rle_text_formats(torch, port, scene, jpeg_s_per_mp, tmpdir):
    """Phase 9j (see the module docstring) on phase 9's `scene` ->
    (results, {view: (file, None or its decode)} for the shared training)."""
    t_phase = time.perf_counter()
    walks = {".ras": [], ".msp": []}
    fixtures = fixture_digests(port, "rle_text", decode_plain_9j,
                               "SUN / MSP / XBM / XPM / PSD",
                               lambda name, data: walks_9j(port, name, data, walks))
    if not all(walks.values()):
        raise AssertionError("no fixture holds a byte-encoded Sun raster or MSP v2 rows")
    walks = {k: float(np.median(v)) for k, v in walks.items()}
    log(f"[rle9j] {len(fixtures)} fixtures decode to their recorded digests through the "
        f"C++ and the plain route; walks plain / C++: gm_sun_rle {walks['.ras']:.1f}, "
        f"gm_msp_rle {walks['.msp']:.1f}")
    exts = {"sun": ".ras", "msp": ".msp", "xbm": ".xbm", "xpm": ".xpm", "psd": ".psd"}
    by_row, expected = reader_views(port, scene, RLE_TEXT_9J, exts, write_9j_view,
                                    decode_plain_9j, "rle9j", jpeg_s_per_mp, tmpdir)
    res = dict(rows=by_row, fixtures=len(fixtures), sun_rle_plain_vs_cpp=walks[".ras"],
               msp_rle_plain_vs_cpp=walks[".msp"], phase_s=time.perf_counter() - t_phase)
    log("[rle9j] " + json.dumps(res))
    return res, expected


# ------------------------------------------------------------------ phase 9k

RAW_SAMPLE_PLAIN = {".fli": "fli", ".flc": "fli", ".iim": "iptc", ".im": "im", ".imt": "imt",
                    ".gbr": "gbr"}


def decode_plain_9k(port, path):
    """A 9k file through the plain route (FLI's plain walk; IPTC, IM, IMT
    and GBR have one route: no C++)."""
    with open(path, "rb") as fh:
        data = fh.read()
    name = RAW_SAMPLE_PLAIN[os.path.splitext(path)[1]]
    mod = getattr(port, name)
    return getattr(mod, f"decode_{name}_plain", getattr(mod, f"decode_{name}"))(data, path)


def fli_walk(port, name, data, walks):
    """`gm_fli_frame` against its plain walk on an FLI fixture's frame (the
    planes equal), plain / C++ appended to `walks`."""
    if os.path.splitext(name)[1] not in (".fli", ".flc"):
        return
    w, h, _, framesize = port.fli.header(data)
    cpp, t_cpp = timed(port.fli._load, data, w, h, framesize, port.fli._frame)
    plain, t_plain = timed(port.fli._load, data, w, h, framesize, port.fli._frame_plain)
    if not np.array_equal(cpp, plain):
        raise AssertionError(f"{name}: gm_fli_frame differs from its plain walk")
    walks.append(t_plain / t_cpp)


def ycc_of(rgb):
    """A view's YCbCr samples (JFIF's forward transform, rounded): the IM
    YCC row's file content."""
    r, g, b = (rgb[..., k].astype(np.float64) for k in range(3))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128 - 0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 128 + 0.5 * r - 0.418688 * g - 0.081312 * b
    return np.clip(np.rint(np.stack([y, cb, cr], -1)), 0, 255).astype(np.uint8)


def write_9k_view(port, row, path, img):
    """View `img` written as row `row` of RAW_SAMPLE_9K -> (what
    `read_image` must give, the writer's s)."""
    t0 = time.perf_counter()
    green = np.ascontiguousarray(img[..., 1])
    want = img
    if row.startswith(("fli", "flc", "im_lut")):
        pal, idx = fixed_palette(LEVELS_256), quantize(img, LEVELS_256)
        if row.startswith("fli"):
            want = pal[idx]
            port.fli.write_fli(path, idx, pal)
        elif row.startswith("flc"):
            want = (pal & 0xFC)[idx]          # 64 levels: PIL shifts them back by 2
            port.fli.write_fli(path, idx, pal, chunk="copy", flc=True, levels=64)
        else:
            want = pal[idx]
            port.im.write_im(path, idx, "P", lut=pal)
    elif row == "iptc_raw_gray":
        want = green
        port.iptc.write_iptc(path, green)
    elif row == "iptc_jpeg_gray":
        port.iptc.write_iptc(path, green, compression="jpeg", quality=EVAL_QUALITY)
        want = port.jpeg.decode_jpeg(port.jpeg.encode_jpeg(green, EVAL_QUALITY))
    elif row == "im_rgb":
        port.im.write_im(path, img, "RGB")
    elif row == "im_ycc_b30":
        ycc = ycc_of(img)
        want = port.im.ycc_to_rgb(ycc)
        port.im.write_im(path, ycc, "YCbCr")
    elif row == "im_l16_b7":
        want = green
        port.im.write_im(path, green.astype(np.uint16) << 8 | img[..., 0], "I;16")
    elif row == "im_cmyk_b14":
        cmyk = cmyk_of(img)
        want = port.jpeg.cmyk_to_rgb(cmyk)
        port.im.write_im(path, cmyk, "CMYK")
    elif row == "imt_gray":
        want = green
        port.imt.write_imt(path, green)
    elif row == "gbr_v1_gray":
        want = green
        port.gbr.write_gbr(path, green, version=1)
    else:
        h, w = img.shape[:2]
        alpha = np.where(mask_9i(h, w), 96, 255).astype(np.uint8)[..., None]
        want = np.concatenate([img, alpha], 2)
        port.gbr.write_gbr(path, want)
    return want, time.perf_counter() - t0


def phase_raw_sample_formats(torch, port, scene, jpeg_s_per_mp, tmpdir):
    """Phase 9k (see the module docstring) on phase 9's `scene` ->
    (results, {view: (file, None or its decode)} for the shared training)."""
    t_phase = time.perf_counter()
    walks = []
    fixtures = fixture_digests(port, "raw_samples", decode_plain_9k,
                               "FLI / IPTC / IM / IMT / GBR",
                               lambda name, data: fli_walk(port, name, data, walks),
                               exts=RAW_SAMPLE_PLAIN)
    if not walks:
        raise AssertionError("no FLI fixture")
    fli_frame = float(np.median(walks))
    log(f"[raw9k] {len(fixtures)} fixtures decode to their recorded digests through the "
        f"C++ and the plain route; gm_fli_frame plain / C++ {fli_frame:.1f}")
    exts = {"fli": ".fli", "flc": ".flc", "ipt": ".iim", "im_": ".im", "imt": ".imt",
            "gbr": ".gbr"}
    by_row, expected = reader_views(port, scene, RAW_SAMPLE_9K, exts, write_9k_view,
                                    decode_plain_9k, "raw9k", jpeg_s_per_mp, tmpdir)
    res = dict(rows=by_row, fixtures=len(fixtures), fli_frame_plain_vs_cpp=fli_frame,
               phase_s=time.perf_counter() - t_phase)
    log("[raw9k] " + json.dumps(res))
    return res, expected


# ------------------------------------------------------------------ phase 9l

SAMPLE_TEXTURE_PLAIN = {".pxr": ("pixar", "decode_pixar"), ".mcidas": ("mcidas", "decode_mcidas"),
                        ".xv": ("xvthumb", "decode_xvthumb"), ".fits": ("fits", "decode_fits"),
                        ".spi": ("spider", "decode_spider"),
                        ".ftc": ("ftex", "decode_ftex_plain"),
                        ".ftu": ("ftex", "decode_ftex_plain")}


def decode_plain_9l(port, path):
    """A 9l file through the plain route (FTEX's BC1 in numpy; PIXAR,
    McIdas, FITS, SPIDER and XV thumbnails have one route: no C++)."""
    with open(path, "rb") as fh:
        data = fh.read()
    mod, name = SAMPLE_TEXTURE_PLAIN[os.path.splitext(path)[1]]
    return getattr(getattr(port, mod), name)(data, path)


def bc1_walk(port, name, data, walks):
    """`gm_bc1_decode` against `_bc1_plain` on a DXT1 FTEX fixture's mipmap
    (equal RGBA), plain / C++ appended to `walks`."""
    if not name.endswith(".ftc"):
        return
    w, h, fmt, mipmap = port.ftex.header(data)
    cpp, t_cpp = timed(port.bcn.decode_bc1, mipmap, w, h)
    plain, t_plain = timed(port.bcn._bc1_plain, mipmap, w, h)
    if fmt != port.ftex.DXT1 or not np.array_equal(cpp, plain):
        raise AssertionError(f"{name}: gm_bc1_decode differs from _bc1_plain")
    walks.append(t_plain / t_cpp)


def write_9l_view(port, row, path, img):
    """View `img` written as row `row` of SAMPLE_TEXTURE_9L -> (what
    `read_image` must give, the writer's s)."""
    t0 = time.perf_counter()
    green = np.ascontiguousarray(img[..., 1])
    wide = green.astype(np.uint16) << 8 | img[..., 0]           # the high byte is the green
    want = green
    if row == "pixar_rgb":
        want = img
        port.pixar.write_pixar(path, img)
    elif row == "mcidas_1byte":
        port.mcidas.write_mcidas(path, green)
    elif row == "mcidas_2byte_b7":
        port.mcidas.write_mcidas(path, wide, size=2)
    elif row == "xvthumb_b15":
        idx = port.xvthumb.rgb332(img)
        want = port.xvthumb.PALETTE[idx]
        port.xvthumb.write_xvthumb(path, idx)
    elif row == "fits_8bit":
        port.fits.write_fits(path, green)
    elif row == "fits_16bit_unsigned_b32":
        port.fits.write_fits(path, wide)
    elif row == "fits_gzip8":
        port.fits.write_fits(path, green, compress=True)
    else:
        want = port.ftex.write_ftex(path, img, fmt=port.ftex.DXT1 if row == "ftex_dxt1"
                                    else port.ftex.UNCOMPRESSED)
    return want, time.perf_counter() - t0


def phase_sample_texture_formats(torch, port, scene, jpeg_s_per_mp, tmpdir):
    """Phase 9l (see the module docstring) on phase 9's `scene` ->
    (results, {view: (file, None or its decode)} for the shared training)."""
    t_phase = time.perf_counter()
    walks = []
    fixtures = fixture_digests(port, "raw_samples", decode_plain_9l,
                               "PIXAR / MCIDAS / XVTHUMB / FITS / SPIDER / FTEX",
                               lambda name, data: bc1_walk(port, name, data, walks),
                               exts=SAMPLE_TEXTURE_PLAIN, least=15)
    if not walks:
        raise AssertionError("no DXT1 FTEX fixture")
    bc1 = float(np.median(walks))
    log(f"[tex9l] {len(fixtures)} fixtures decode to their recorded digests through the "
        f"C++ and the plain route, SPIDER refused through both; gm_bc1_decode plain / C++ "
        f"{bc1:.1f}")
    exts = {"pix": ".pxr", "mci": ".mcidas", "xvt": ".xv", "fit": ".fits", "fte": ".ftc"}
    by_row, expected = reader_views(port, scene, SAMPLE_TEXTURE_9L, exts, write_9l_view,
                                    decode_plain_9l, "tex9l", jpeg_s_per_mp, tmpdir)
    res = dict(rows=by_row, fixtures=len(fixtures), bc1_plain_vs_cpp=bc1,
               phase_s=time.perf_counter() - t_phase)
    log("[tex9l] " + json.dumps(res))
    return res, expected


# ------------------------------------------------------------------ phase 9m

def decode_plain_9m(port, path):
    """A 9m file through the plain route (the BCn blocks in numpy, BLP1's
    JPEG in Python)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if path.endswith(".dds"):
        return port.dds.decode_dds_plain(data, path)
    return port.blp.decode_blp_plain(data, path)


def bcn_walks(port, name, data, walks):
    """`gm_bcn_decode` against `bcn.decode_plain` on a DDS or BLP fixture's
    blocks (equal bytes), plain / C++ appended to `walks` by kind."""
    if name.endswith(".dds"):
        w, h, form, where, args = port.dds.header(data)
        if form != "bcn":
            return
        (kind, signed), shift, body = args, False, data[where:]
    else:
        hd = port.blp.header(data)
        if hd["magic"] != b"BLP2" or hd["encoding"] != port.blp.DXT:
            return
        w, h, signed, shift = hd["width"], hd["height"], False, True
        kind = port.blp.DXT_KINDS[hd["alpha_encoding"]]
        offset = struct.unpack_from("<I", data, hd["head"])[0]
        body = data[offset:offset + port.bcn.BLOCK_BYTES[kind] * port.bcn.bc1_blocks(w, h)]
    kw = dict(signed=signed, shift565=shift)
    cpp, t_cpp = timed(lambda: port.bcn.decode(kind, body, w, h, **kw))
    plain, t_plain = timed(lambda: port.bcn.decode_plain(kind, body, w, h, **kw))
    if not np.array_equal(cpp, plain):
        raise AssertionError(f"{name}: gm_bcn_decode differs from bcn.decode_plain")
    label = ("BLP DXT" if shift else "BC") + str({1: 1, 2: 3, 3: 5}[kind] if shift else
                                                 "6H" if kind == port.bcn.BC6H else kind)
    walks.setdefault(label + ("S" if signed else ""), []).append(t_plain / t_cpp)


def luma(img):
    """PIL's `convert("L")` of an RGB image (ITU-R 601-2, 16-bit fixed
    point)."""
    c = img.astype(np.uint32)
    return ((c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471 + 0x8000) >> 16).astype(
        np.uint8)


def write_9m_view(port, row, path, img):
    """View `img` written as row `row` of TEXTURE_9M -> (what `read_image`
    must give, the writer's s)."""
    t0 = time.perf_counter()
    h, w = img.shape[:2]
    opaque = np.dstack([img, np.full((h, w), 255, np.uint8)])
    if row.startswith("dds"):
        arg, form = {"dds_dxt1_rgba": (img, "DXT1"),
                     "dds_dxt5_ellipse_alpha": (np.dstack(
                         [img, np.where(mask_9i(h, w), 0, 255).astype(np.uint8)]), "DXT5"),
                     "dds_dx10_bc7_mode6": (opaque, "BC7"), "dds_bc4_luma": (luma(img), "BC4"),
                     "dds_bc5_rg": (img, "BC5"), "dds_rgb565_masks": (img, "RGB565"),
                     "dds_dx10_bc6h_uf16": (img, "BC6H"),
                     "dds_dx10_bc6h_sf16": (img, "BC6HS")}[row]
        want = port.dds.write_dds(path, arg, form)
    elif row == "blp2_palette_256":
        want = port.blp.write_blp(path, quantize(img, LEVELS_256), "BLP2_PALETTE",
                                  palette=fixed_palette(LEVELS_256))
    else:
        want = port.blp.write_blp(path, img, "BLP1_JPEG" if row == "blp1_jpeg_bgr"
                                  else "BLP2_DXT1", quality=EVAL_QUALITY)
    return want, time.perf_counter() - t0


def phase_texture_formats(torch, port, scene, jpeg_s_per_mp, tmpdir):
    """Phase 9m (see the module docstring) on phase 9's `scene` ->
    (results, {view: (file, None or its decode)} for the shared training)."""
    t_phase = time.perf_counter()
    walks = {}
    fixtures = fixture_digests(port, "textures", decode_plain_9m, "DDS / BLP",
                               lambda name, data: bcn_walks(port, name, data, walks),
                               least=40)
    want = {"BC1", "BC2", "BC3", "BC4", "BC5", "BC5S", "BC6H", "BC6HS", "BC7", "BLP DXT1",
            "BLP DXT3", "BLP DXT5"}
    if set(walks) != want:
        raise AssertionError(f"the fixtures' block kinds {sorted(walks)}, not {sorted(want)}")
    ratios = {k: float(np.median(v)) for k, v in sorted(walks.items())}
    log(f"[tex9m] {len(fixtures)} fixtures decode to their recorded digests through the "
        "C++ and the plain route (BC6H of every mode and both signs, B38's oracle), B34 and "
        "raw BGRA refused through both; gm_bcn_decode = decode_plain, plain / C++ by kind "
        + json.dumps(
            {k: round(v, 1) for k, v in ratios.items()}))
    by_row, expected = reader_views(port, scene, TEXTURE_9M, {"dds": ".dds", "blp": ".blp"},
                                    write_9m_view, decode_plain_9m, "tex9m", jpeg_s_per_mp,
                                    tmpdir)
    res = dict(rows=by_row, fixtures=len(fixtures), bcn_plain_vs_cpp=ratios,
               phase_s=time.perf_counter() - t_phase)
    log("[tex9m] " + json.dumps(res))
    return res, expected


# ------------------------------------------------------ the readers' training

def loaded_target(torch, port, decoded, size):
    """A decode as `data/readers.py::_load_image` makes it the training
    target of a COLMAP view (no background): resized, gray repeated to RGB,
    an alpha dropped, the uint8 of float32 / 255 -> (3, H, W) uint8."""
    arr = port.resample.resize(decoded, size).astype(np.float32) / 255.0
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=2)
    return torch.from_numpy((arr[..., :3].transpose(2, 0, 1) * 255).astype(np.uint8))


def texture_or_lossless(port, path):
    """"BC6H" for a DX10 BC6H texture, "lossless JPEG" for an SOF3 file,
    "arithmetic JPEG" for an SOF9 or SOF10 one, "Zstandard TIFF" for a TIFF
    of compression 50000, else None."""
    with open(path, "rb") as fh:
        data = fh.read()
    if path.endswith(".tif"):
        return "Zstandard TIFF" if port.tiff._tags(data, path).get(259) == [50000] else None
    if path.endswith(".dds"):
        _, _, form, _, args = port.dds.header(data)
        return "BC6H" if form == "bcn" and args[0] == port.bcn.BC6H else None
    head = data[:jpeg_scan_starts(data)[0]] if data[:2] == b"\xff\xd8" else b""
    if b"\xff\xc3" in head:
        return "lossless JPEG"
    if b"\xff\xc9" in head or b"\xff\xca" in head:
        return "arithmetic JPEG"
    return None


def phase_reader_training(torch, port, scene, views, tmpdir):
    """The reader phases' shared training (see the module docstring): view i
    of phase 9's scene from the file phase `reader_phase(i)` wrote for it
    (`views`: {phase: {view: (file, None where it decodes to phase 9's
    baseline decode, else its decode)}}) -> (results, launches)."""
    t_phase = time.perf_counter()
    root = os.path.join(tmpdir, "readers_data", "s")
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(os.path.join(root, "images"))
    cams, images, (xyz, rgb, err) = port.colmap.read_model(
        os.path.join(scene["root"], "sparse", "0"))
    taken, forms = {}, {"BC6H": 0, "lossless JPEG": 0, "arithmetic JPEG": 0,
                        "Zstandard TIFF": 0}
    for iid, img in images.items():
        i = iid - 1
        phase = reader_phase(i)
        path, decoded = views[phase][i]
        form = texture_or_lossless(port, path)
        if form and i % 8:                  # a training view (llffhold 8 holds out the rest)
            forms[form] += 1
        if decoded is not None and decoded.ndim == 3 and decoded.shape[2] == 4:
            # an alpha makes a mask, and `DeviceDataset` (as the JAX trainer's) stacks
            # masks only where the first view has one: such a view trains from phase 9's
            # JPEG instead, whatever the camera shuffle puts first
            phase, path, decoded = "9", os.path.join(scene["root"], "images",
                                                     f"{i:03d}.jpg"), None
        name = f"{i:03d}_{phase}{os.path.splitext(path)[1]}"
        shutil.copy(path, os.path.join(root, "images", name))
        images[iid] = dataclasses.replace(img, name=name)
        taken[i] = (phase, decoded)
    port.colmap.write_model_binary(sparse, cams, images, xyz, rgb, err)
    cfg = scene["cfg"]
    trainer, launches, rows = run_cli(torch, port, port.cli_train_mesh.main, [
        "-s", root, "-m", os.path.join(tmpdir, "readers_out"), "--input_mesh",
        scene["proxy"], "--eval", "--iterations", str(PROGRESSIVE_ITERS), "--device", "cuda",
        "--init_target", str(INIT_TARGET), "--max_per_tile", str(cfg.max_per_tile),
        "--pair_capacity_per_gaussian", str(cfg.pair_capacity_per_gaussian),
        "--row_capacity_per_gaussian", str(cfg.row_capacity_per_gaussian),
        *scene["sched"]], port.trainer.MeshTrainer)
    want = {"K1": PROGRESSIVE_ITERS, "K2": PROGRESSIVE_ITERS, "K3": PROGRESSIVE_ITERS}
    assert launches == want, launches
    if min(forms.values()) < 1:
        raise AssertionError(f"the training views hold {forms}: a BC6H, a lossless JPEG, "
                             "an arithmetic JPEG and a Zstandard TIFF view at least")
    steps = step_summary(rows["steps"], "readers")
    for name, p in trainer.model.named_parameters():
        assert torch.isfinite(p).all(), name
    ds, ref = trainer.ds, scene["targets"]
    for key in ("view", "proj", "campos"):
        if not torch.equal(getattr(ds, key), getattr(ref, key)):
            raise AssertionError(f"the readers' scene's training {key} differ from phase 9's")
    centres = np.stack([pos for _, pos, _ in scene["cams"]])
    size = (int(ds.width), int(ds.height))
    n_lossless, by_phase = 0, {}
    for k in range(ds.images.shape[0]):
        i = int(np.argmin(np.linalg.norm(centres - ds.campos[k].cpu().numpy(), axis=1)))
        phase, decoded = taken[i]
        if decoded is None:
            target, n_lossless = ref.images[k], n_lossless + 1
        else:
            target = loaded_target(torch, port, decoded, size).to(ds.images.device)
        if not torch.equal(ds.images[k], target):
            which = "phase 9's" if decoded is None else "the resize of its decode"
            raise AssertionError(f"view {i} (phase {phase}): its training target differs "
                                 f"from {which}")
        by_phase[phase] = by_phase.get(phase, 0) + 1
    res = dict(train_views_by_phase=by_phase, train_views=int(ds.images.shape[0]),
               train_lossless_views=n_lossless, train_views_by_new_form=forms,
               load_s=(rows["scene"][0][0] + rows["upload"][0][0]) / 1e3,
               train_s=sum(t for t, _ in rows["steps"]) / 1e3, **steps,
               phase_s=time.perf_counter() - t_phase)
    log("[readers] " + json.dumps(res))
    return res, launches


# ------------------------------------------------------------------ phase 10

def phase_acap(torch, port):
    """10a. The host extractor (`edit/native_acap.py`, C++ / OpenMP) on the
    slice model's icosphere-7 mesh and phase 7's largest twist frame,
    against the port's `deformation_gradients` on the card in float64 (the
    same normalised rings, eps, guards and Newton steps: 1e-4), and beside
    the float32 card path playback runs (whose rounding of the ~1e-4-flat
    rings sets a floor near 2e-3 at this level; `RS_F32_FLOOR`); a rigid
    frame made in float64 gives R = Q (1e-4), one made in float32 within
    `RIGID_F32_BAR`."""
    v, f = icosphere(SUBDIV)
    frame = twist_frames(v, PLAYBACK_FRAMES)[PLAYBACK_FRAMES // 4]
    t0 = time.perf_counter()
    nat = port.native_acap.NativeACAP((v, f))
    setup_s = time.perf_counter() - t0
    nat.get_rs(frame)                                     # warm
    t0 = time.perf_counter()
    for _ in range(ACAP_CALLS):
        r, s = nat.get_rs(frame)
    host_ms = (time.perf_counter() - t0) * 1e3 / ACAP_CALLS
    d = port.deform.MeshDeformer(v, f, device="cuda")
    vd = torch.tensor(frame, device="cuda")
    card_ms, _ = timed_frames(torch, lambda i: d.get_rs(vd), ACAP_CALLS)
    r32, s32 = d.get_rs(vd)
    r64, s64 = port.deform.deformation_gradients(d.v_ref.double(), vd.double(),
                                                 d.neighbors, d.mask)

    def err(a, b):
        return float(np.abs(a - b.cpu().numpy()).max())

    q = rotation([0.3, 1.0, 0.2], 0.7)
    rq, _ = nat.get_rs(v.astype(np.float64) @ q.T + [0.5, -0.2, 0.1])
    rq32, _ = nat.get_rs((v @ q.T + [0.5, -0.2, 0.1]).astype(np.float32))
    res = dict(vertices=int(v.shape[0]), threads=os.cpu_count(), setup_s=setup_s,
               host_ms=host_ms, card_deform_ms=float(np.median(card_ms)),
               r_vs_card_f64=err(r, r64), s_vs_card_f64=err(s, s64),
               r_vs_card_f32=err(r, r32), s_vs_card_f32=err(s, s32),
               rigid_f64_r_vs_q=float(np.abs(rq - q).max()),
               rigid_f32_r_vs_q=float(np.abs(rq32 - q).max()))
    log("[acap] " + json.dumps(res))
    assert res["r_vs_card_f64"] <= 1e-4 and res["s_vs_card_f64"] <= 1e-4, res
    assert res["r_vs_card_f32"] <= RS_F32_FLOOR and res["s_vs_card_f32"] <= RS_F32_FLOOR
    assert res["rigid_f64_r_vs_q"] <= 1e-4, res
    assert res["rigid_f32_r_vs_q"] <= RIGID_F32_BAR, res
    return res


def phase_viewer(torch, port, cfg, tmpdir):
    """10b. `ViewerServer` on 127.0.0.1, port 0, serving `editor_render_fn`
    of the slice model (its PLY and icosphere-7 mesh) at 1920x1080: 8
    `GET /frame` at the slice's orbit angles, each PNG equal to the uint8
    quantisation of the in-process `SceneEditor.render` (0 levels), K1 once
    per frame, no overflow, `/state` 8 frames, a render that raises a 500.
    -> (results, launches)."""
    import urllib.error
    import urllib.request

    vw = port.viewer
    editor = port.runtime.SceneEditor(device="cuda")
    editor.add_object(os.path.join(tmpdir, "point_cloud.ply"),
                      os.path.join(tmpdir, "origin.obj"), name="object")
    bg = (1.0, 1.0, 1.0)
    server = vw.ViewerServer(vw.editor_render_fn(editor, cfg, bg), width=WIDTH,
                             height=HEIGHT, port=0, radius=4.0).start()
    base = f"http://{server.host}:{server.port}"
    angles = [(2 * math.pi * i / N_VIEWS, 0.3) for i in range(VIEWER_FRAMES)]
    try:
        torch.cuda.synchronize()
        reset_launches(port)                                 # main path starts
        pngs, request_ms = [], []
        for theta, phi in angles:
            t0 = time.perf_counter()
            pngs.append(urllib.request.urlopen(
                f"{base}/frame?theta={theta!r}&phi={phi}&r=4.0", timeout=120).read())
            request_ms.append((time.perf_counter() - t0) * 1e3)
        launches = read_launches(port)                       # main path ends
        state = json.loads(urllib.request.urlopen(f"{base}/state", timeout=30).read())
        try:
            urllib.request.urlopen(f"{base}/frame?w=-32", timeout=60)
            code = 200
        except urllib.error.HTTPError as e:
            code, text = e.code, e.read().decode()
        frame_ms = list(server.frame_ms)
    finally:
        server.stop()
    levels = []
    with torch.no_grad():
        for (theta, phi), data in zip(angles, pngs):
            cam = vw.orbit_camera(theta, phi, 4.0, WIDTH, HEIGHT)
            out = editor.render(cam, cfg, bg_color=torch.tensor(bg, device="cuda"))
            assert int(out.tile_overflow) == 0 and int(out.rect_overflow) == 0
            want = vw.to_uint8(out.color.cpu())
            got = port.png.decode_png(data)
            assert got.shape == (HEIGHT, WIDTH, 3), got.shape
            levels.append(int(np.abs(got.astype(int) - want).max()))
    res = dict(frames=len(pngs), png_bytes=int(np.mean([len(x) for x in pngs])),
               max_levels=max(levels), state=state, error_code=code,
               request_ms_median=float(np.median(request_ms)),
               render_ms_median=float(np.median([a for a, _ in frame_ms])),
               encode_ms_median=float(np.median([b for _, b in frame_ms])),
               request_ms=[round(x, 2) for x in request_ms], launches=launches)
    log("[viewer] " + json.dumps(res))
    assert max(levels) == 0, levels
    assert launches == {"K1": VIEWER_FRAMES, "K2": 0, "K3": 0}, launches
    assert state["frames_served"] == VIEWER_FRAMES, state
    assert code == 500 and text, code
    return res, launches


def phase_e2e(torch, tmpdir):
    """10c. `GM_DEVICE=cuda GM_E2E_ITERATIONS=10 bash
    examples/synthetic_e2e_torch.sh`: exit 0, its renders, results.json and
    edit frames; each step's seconds from its `[e2e-step]` marks."""
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(tmpdir, "e2e")
    t0 = time.perf_counter()
    proc = subprocess.run(["bash", os.path.join(root, "examples", "synthetic_e2e_torch.sh"),
                           work], cwd=root, env={**os.environ, "GM_DEVICE": "cuda",
                                                 "GM_E2E_ITERATIONS": str(E2E_ITERATIONS)},
                          capture_output=True, text=True, timeout=E2E_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        log(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise AssertionError(f"synthetic_e2e_torch.sh exited {proc.returncode}")
    model = os.path.join(work, "model")
    ours = f"ours_{E2E_ITERATIONS}"
    renders = sorted(os.listdir(os.path.join(model, "test", ours, "renders")))
    results = json.load(open(os.path.join(model, "results.json")))[ours]
    frames = sorted(os.listdir(os.path.join(work, "edit_out")))
    marks = [line.split()[1:] for line in proc.stdout.splitlines()
             if line.startswith("[e2e-step] ")]
    steps = {a[0]: float(b[1]) - float(a[1]) for a, b in zip(marks, marks[1:])}
    res = dict(seconds=wall, step_s=steps, renders=len(renders), edit_frames=len(frames),
               psnr=results["PSNR"], ssim=results["SSIM"],
               last_lines=proc.stdout.strip().splitlines()[-3:])
    log("[e2e] " + json.dumps(res))
    assert renders == ["00000.png", "00001.png"] and len(frames) == 8, res
    assert list(steps) == ["make_dataset", "train_mesh", "render", "metrics", "deformed_mesh",
                           "edit"], steps
    assert math.isfinite(res["psnr"]), res
    return res


def phase_bands(torch, port, model, cam, cfg):
    """10d. The slice's view 0 as 4 bands through `rasterize_band`, one at a
    time: stitched, equal to the full render within 2e-5."""
    pts = port.train_step
    bg = torch.ones(3, device="cuda")
    gy_local = port.sharding.band_rows(port.sharding.padded_grid_y(HEIGHT, 4), 4)
    with torch.no_grad():
        a = port.render.mesh_model_arrays(model, cam, SH_DEGREE)
        full = port.render.render(a, cam, cfg, bg)
        reset_launches(port)
        bands = [pts.rasterize_band(a, cam, cfg, gy_local, i * gy_local, bg)
                 for i in range(4)]
        launches = read_launches(port)
    stitched = torch.cat([b.color for b in bands], 1)[:, :HEIGHT]
    err = (stitched - full.color).abs().max().item()
    res = dict(bands=4, rows_per_band=gy_local * 16, max_abs=err, launches=launches,
               num_rendered=[int(b.num_rendered) for b in bands],
               full_num_rendered=int(full.num_rendered))
    log("[bands] " + json.dumps(res))
    assert err <= 2e-5, res
    assert all(torch.equal(b.radii, full.radii) for b in bands)
    assert launches == {"K1": 4, "K2": 0, "K3": 0}, launches
    return res


def reference_step(torch, port, trainer, cams, bg):
    """The single-process reference of one 2x2 step over the same views, on
    the card: a copy of the trainer's state, the mean of the views' losses
    plus the mesh-restrict loss, one Adam update with the trainer's moments,
    the per-view densification statistics."""
    state = trainer.capture()
    tr = port.trainer.MeshTrainer(*icosphere(PROXY_SUBDIV), trainer.ds, trainer.opt,
                                  trainer.rt, spatial_lr_scale=SHARD_LR_SCALE,
                                  init_target=0, max_sh_degree=SH_DEGREE)
    tr.restore(state)
    m, opt, ds = tr.model, tr.opt, tr.ds
    lam = opt.lambda_dssim
    params = m.params()
    total, accum, denom = 0.0, m.state.grad_accum.clone(), m.state.denom.clone()
    for idx in cams:
        cam, gt = ds.camera(idx), ds.target(idx, bg)
        off = torch.zeros((m.capacity, 2), device=tr.device, requires_grad=True)
        out = port.render.render(port.render.mesh_model_arrays(m, cam, tr.sh_degree),
                                 cam, tr.raster_cfg(), bg, mean2d_offset=off)
        view = ((1 - lam) * port.loss.l1_loss(out.color, gt)
                + lam * (1 - port.loss.ssim(out.color, gt)))
        total = total + view / len(cams)
        g_off = torch.autograd.grad(view, off, retain_graph=True)[0]
        st = port.densify.add_densification_stats(m.state, g_off, out.visibility,
                                                  ds.width, ds.height)
        accum += st.grad_accum - m.state.grad_accum
        denom += st.denom - m.state.denom
    total = total + port.loss.mesh_restrict_loss(m.get_scaling(), m.vertex1, m.vertex2,
                                                 m.vertex3, m.alive, opt.alpha_mrloss)
    grads = torch.autograd.grad(total, list(params.values()), allow_unused=True)
    tr.adam.update(params, {k: torch.zeros_like(p) if g is None else g
                            for (k, p), g in zip(params.items(), grads)})
    return dict(loss=float(total.detach()),
                params={k: v.detach().cpu() for k, v in params.items()},
                grad_accum=accum.detach().cpu(), denom=denom.cpu())


def shard_inputs(torch, port, trainer, playback_cfg, cam, tmpdir):
    """10e and 10f's inputs: the phase-6 student's state, its dataset and
    the single-process reference of the first step, written for the ranks;
    nccl refused for 4 ranks on one card. -> (the directory, s, nccl's
    refusal)."""
    work = os.path.join(tmpdir, "shard")
    os.makedirs(work)
    ds = trainer.ds
    cams = [0, TRAIN_VIEWS // 2]
    t0 = time.perf_counter()
    torch.save(dict(
        state=trainer.capture(), opt=dataclasses.asdict(trainer.opt),
        rt=dataclasses.asdict(trainer.rt), cams=cams,
        data={k: getattr(ds, k).cpu() for k in ("view", "proj", "campos", "tanfovx",
                                                "tanfovy", "images")},
        size=(ds.width, ds.height), cam=[x.cpu() for x in cam],
        playback_cfg=dataclasses.asdict(playback_cfg),
        paths=[os.path.join(tmpdir, "point_cloud.ply"), os.path.join(tmpdir, "origin.obj")]),
        os.path.join(work, "inputs.pt"))
    torch.save(reference_step(torch, port, trainer, cams, trainer.bg_const),
               os.path.join(work, "reference.pt"))
    prep_s = time.perf_counter() - t0
    log(f"[shard-s] inputs and reference {prep_s:.1f}")

    world = SHARD_WORLD[0] * SHARD_WORLD[1]
    backend, cards = rank_plan(world, torch.cuda.device_count())
    nccl_refused = None
    if backend == "gloo":
        # NCCL refuses more ranks than cards: the port raises before it tries
        env_keys = ("WORLD_SIZE", "LOCAL_WORLD_SIZE")
        kept = {k: os.environ.get(k) for k in env_keys}
        os.environ.update(WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
        try:
            port.multihost.initialize(backend="nccl")
            raise AssertionError("nccl with 4 ranks on one card did not raise")
        except RuntimeError as e:
            nccl_refused = str(e)
        finally:
            for k, v in kept.items():
                os.environ.pop(k) if v is None else os.environ.__setitem__(k, v)
    return work, prep_s, nccl_refused


def shard_checks(work, backend, cards, prep_s, nccl_refused, wall):
    """10e and 10f's rank reports checked -> (results, launches summed over
    the ranks, band kernels)."""
    world = SHARD_WORLD[0] * SHARD_WORLD[1]
    reports = [json.load(open(os.path.join(work, f"rank{r}.json"))) for r in range(world)]
    r0 = reports[0]
    for rep in reports:
        assert rep["ok"], rep
        assert rep["hashes"] == r0["hashes"] and rep["losses"] == r0["losses"], rep
        assert (rep["backend"], rep["card"]) == (backend, cards[rep["rank"]]), rep
    launches = {k: sum(rep["launches"][k] + rep["playback_launches"][k]
                       for rep in reports) for k in ("K1", "K2", "K3")}
    res = dict(world=SHARD_WORLD, backend=backend, cards=cards, prep_s=prep_s, wall_s=wall,
               nccl_refused=nccl_refused,
               step1=[rep["step1"] for rep in reports], losses=r0["losses"],
               events=r0["events"], hashes_equal=True,
               step_ms_median=[rep["step_ms_median"] for rep in reports],
               gloo_cuda=r0["gloo_cuda"],
               playback=[rep["playback"] for rep in reports],
               rank_launches=[rep["launches"] for rep in reports])
    log("[shard] " + json.dumps({k: v for k, v in res.items() if k != "losses"}))
    log(f"[shard] losses {[round(x, 5) for x in r0['losses']]}")
    return res, launches, tuple(r0["band_kernels"])


def phase_shards(torch, port, trainer, playback_cfg, cam, tmpdir):
    """10e, 10f and 10g: the (data, tile) regime on SHARD_WORLD ranks and the
    Gaussian-table shard on GSHARD_WORLD that share the one card over gloo
    (a rehearsal: it checks, it measures no multi-card speed). The parent
    writes both phases' inputs, spawns the ranks once (`shard_rank`, then
    `gshard_rank` in the same processes: one start for both), joins each
    with a timeout and checks their reports. -> (10e / 10f's results,
    launches and band kernels; 10g's results, launches, received band
    kernels and owner K3)."""
    import gc

    world = SHARD_WORLD[0] * SHARD_WORLD[1]
    assert world == GSHARD_WORLD, (world, GSHARD_WORLD)
    shard_work, shard_prep, nccl_refused = shard_inputs(torch, port, trainer, playback_cfg,
                                                        cam, tmpdir)
    gshard = gshard_inputs(torch, port, trainer, tmpdir)
    backend, cards = rank_plan(world, torch.cuda.device_count())
    # the ranks need the card's memory that earlier phases left cached here
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--ranks", str(r),
                               str(world), shard_work, gshard["work"], backend, str(cards[r])],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = join_ranks(procs, SHARD_JOIN_S)
    wall = time.perf_counter() - t0
    log(f"[shards-s] ranks of 10e-10g {wall:.1f}")
    for r, out in enumerate(outs):
        for line in out.strip().splitlines()[-100:]:
            log(f"[shards] rank {r}: {line}")
    return (*shard_checks(shard_work, backend, cards, shard_prep, nccl_refused, wall),
            *gshard_checks(gshard, backend, cards, wall))


def ranks_main(rank, world, shard_work, gshard_work, backend, card):
    """One rank process of 10e / 10f (`shard_rank`), then of 10g
    (`gshard_rank`), each in its own process group."""
    import gc

    import torch

    shard_rank(rank, world, shard_work, backend, card)
    gc.collect()
    torch.cuda.empty_cache()
    return gshard_rank(rank, world, gshard_work, backend, card)


def rank_plan(world, n_cards):
    """(backend, card of each rank) of the phase-10 ranks: with fewer cards
    than ranks they share card 0 over gloo (a rehearsal); with a card per
    rank, rank r takes card r over nccl."""
    if n_cards >= world:
        return "nccl", list(range(world))
    return "gloo", [0] * world


def join_group(rank, world, work, backend, card):
    """This rank's process group from a FileStore in `work`, on `card`
    (`rank_plan`); under nccl the card is bound to the group."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(card)
    bound = {"device_id": torch.device("cuda", card)} if backend == "nccl" else {}
    dist.init_process_group(backend, store=dist.FileStore(os.path.join(work, "store"), world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=SHARD_GROUP_TIMEOUT_S), **bound)
    os.environ["GM_DIST_TIMEOUT"] = str(SHARD_GROUP_TIMEOUT_S)


def join_ranks(procs, timeout):
    """Wait for every rank until `timeout` s; on expiry kill them all and
    fail; fail on any non-zero exit. -> each rank's output."""
    deadline = time.monotonic() + timeout
    outs = []
    for r, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError(f"rank {r} still running after {timeout} s: killed")
        outs.append(out)
        if p.returncode != 0:
            for q in procs:
                q.kill()
            raise AssertionError(f"rank {r} exited {p.returncode}:\n{out[-6000:]}")
    return outs


def state_hash(trainer):
    """sha256 over the bytes of every parameter, binding field, statistic,
    Adam moment and the vertex pool."""
    import hashlib

    import torch

    h = hashlib.sha256()
    m = trainer.model
    for tree in (m.params(), m.binding(), m.state._asdict(), trainer.adam.mu,
                 trainer.adam.nu, {"v": m.mesh_v.v}):
        for k in sorted(tree):
            h.update(k.encode())
            h.update(tree[k].detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def shard_rank(rank, world, work, backend, card):
    """One rank of phase 10e / 10f, on `card`, in a `backend` group from a
    FileStore in `work` (`rank_plan`): load the phase-6 state; the first 2x2 step against
    the parent's single-process reference; 20 more steps with a densify and
    an opacity reset inside, the state hashes all-gathered after each event
    and at the end; one more step recording the band arguments (rank 0
    holds K1-K3 against their plain versions there); sharded config-3
    playback, 2 frames a call, against the single-process frames. Writes
    `rank<r>.json`."""
    import torch
    import torch.distributed as dist

    lap = Laps("shard")
    join_group(rank, world, work, backend, card)
    port = load_port()
    inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    ref = torch.load(os.path.join(work, "reference.pt"), weights_only=False)
    width, height = inp["size"]
    d = {k: v.cuda() for k, v in inp["data"].items()}
    ds = port.trainer.DeviceDataset(d["view"], d["proj"], d["campos"], d["tanfovx"],
                                    d["tanfovy"], d["images"], None, width, height)
    opt = port.config.OptimizationParams(**inp["opt"])
    # twice phase 6's max_per_tile: two more densifies pile pairs into tiles
    rt = port.config.RuntimeParams(**{**inp["rt"], "data_axis": SHARD_WORLD[0],
                                      "tile_axis": SHARD_WORLD[1],
                                      "max_per_tile": 2 * inp["rt"]["max_per_tile"]})
    tr = port.trainer.MeshTrainer(*icosphere(PROXY_SUBDIV), ds, opt, rt,
                                  spatial_lr_scale=SHARD_LR_SCALE, init_target=0,
                                  max_sh_degree=SH_DEGREE)
    tr.restore(inp["state"])
    mesh = tr.mesh
    report = dict(rank=rank, ok=False, backend=dist.get_backend(),
                  card=torch.cuda.current_device())

    # gloo's collectives on CUDA tensors, which the port hands them as they are
    report["gloo_cuda"] = {} if backend == "gloo" else None
    for name, fn in (("all_reduce", lambda x: dist.all_reduce(x)),
                     ("all_gather", lambda x: dist.all_gather(
                         [torch.empty_like(x) for _ in range(world)], x)),
                     ("all_to_all_single", lambda x: dist.all_to_all_single(
                         torch.empty_like(x), x))) if backend == "gloo" else ():
        try:
            fn(torch.ones(4, device="cuda"))
            torch.cuda.synchronize()
            report["gloo_cuda"][name] = "accepted"
        except RuntimeError as e:
            report["gloo_cuda"][name] = f"refused: {str(e).splitlines()[0][:120]}"
    port.multihost.barrier()
    lap("join, load, gloo probes")

    # step 1 against the single-process reference
    reset_launches(port)
    m1 = tr.sharded_step(torch.tensor(inp["cams"]), tr.bg_const)
    torch.cuda.synchronize()
    step1_launches = read_launches(port)
    params = tr.model.params()
    rel = {k: float(((params[k].detach().cpu() - ref["params"][k]).abs().max()
                     / ref["params"][k].abs().max().clamp(min=1e-30)))
           for k in params}
    report["step1"] = dict(
        loss=float(m1["loss"]), ref_loss=ref["loss"],
        loss_rel=abs(float(m1["loss"]) - ref["loss"]) / abs(ref["loss"]),
        param_rel=max(rel.values()), param_rel_by_leaf=rel,
        grad_accum_abs=float((tr.model.state.grad_accum.cpu() - ref["grad_accum"]).abs().max()),
        denom_equal=bool(torch.equal(tr.model.state.denom.cpu(), ref["denom"])),
        launches=step1_launches)
    s1 = report["step1"]
    assert s1["loss_rel"] <= 1e-4 and s1["param_rel"] <= 5e-4, s1
    assert s1["grad_accum_abs"] <= 1e-5 and s1["denom_equal"], s1
    assert step1_launches == {"K1": 1, "K2": 1, "K3": 1}, step1_launches
    lap("step 1")

    # 20 more steps: a white-background reset and a densify early, then 15
    # steps without an event; hashes after every event and at the end
    tr.global_it = 0          # the schedule below counts from here
    tr.opt = dataclasses.replace(opt, densify_from_iter=2, densification_interval=3,
                                 densify_until_iter=8, opacity_reset_interval=6)
    hashes, losses, times, n_events = [], [], [], [0]
    clock = [time.perf_counter()]

    def gathered_hash():
        out = [None] * world
        dist.all_gather_object(out, state_hash(tr))
        assert len(set(out)) == 1, out
        return out[0]

    def on_step(m):
        torch.cuda.synchronize()
        now = time.perf_counter()
        times.append((now - clock[0]) * 1e3)
        losses.append(m["loss"])
        assert m["tile_overflow"] == 0 and m["rect_overflow"] == 0, m
        if len(tr.events) > n_events[0]:
            n_events[0] = len(tr.events)
            hashes.append(gathered_hash())
        clock[0] = time.perf_counter()

    reset_launches(port)
    tr.train(SHARD_STEPS, log_every=1, callback=on_step)
    launches = read_launches(port)
    hashes.append(gathered_hash())
    kinds = [(it, kind) for it, kind, _ in tr.events]
    assert kinds == [(2, "opacity_reset"), (3, "densify"), (6, "densify"),
                     (6, "opacity_reset")], kinds
    assert launches == {"K1": SHARD_STEPS, "K2": SHARD_STEPS, "K3": SHARD_STEPS}, launches
    assert all(math.isfinite(x) for x in losses), losses
    free = losses[8:]
    assert np.mean(free[-4:]) < np.mean(free[:4]), losses
    lap(f"{SHARD_STEPS} steps")
    report.update(hashes=hashes, losses=losses, events=tr.events,
                  launches={k: launches[k] + step1_launches[k] for k in launches},
                  step_ms_median=float(np.median(times[8:])),
                  n_alive=int(tr.model.alive.sum()))

    # one more step, recording the band arguments; rank 0 checks the kernels
    seen = capture_step(torch, port, tr, torch.tensor(inp["cams"]))
    band = [None, None, None]
    if rank == 0:
        k1, _, _, blended = check_k1(torch, port.tile_blend, seen["K1"], rt.max_per_tile)
        rows, grouped_pos, seg_starts = seen["K3"]
        k2, k3 = check_k2_k3(torch, port, seen["K2"], grouped_pos, seg_starts, blended,
                             step_rows=rows)
        band = [k1, k2, k3]
        for key, r in zip(("K1", "K2", "K3"), band):
            log(f"[band] {key} at a band step's shapes: " + json.dumps(r))
    report["band_kernels"] = band
    port.multihost.barrier()
    lap("band kernels")

    # 10f: sharded config-3 playback against the single-process frames
    pcfg = port.rasterize.RasterizerConfig(**inp["playback_cfg"])
    cam = port.graphics.CameraArrays(*(x.cuda() for x in inp["cam"]))
    editor = port.runtime.SceneEditor(device="cuda")
    editor.add_object(*inp["paths"], name="main")
    frames = torch.tensor(twist_frames(icosphere(SUBDIV)[0], PLAYBACK_FRAMES),
                          device="cuda")
    fn = port.edit_step.make_sharded_playback_fn(mesh, editor, "main", cam, pcfg,
                                                 bg_color=(1.0, 1.0, 1.0))
    fn(frames[:SHARD_WORLD[0]])                              # warm
    torch.cuda.synchronize()
    calls = [frames[i:i + SHARD_WORLD[0]] for i in range(0, 2 * SHARD_WORLD[0],
                                                          SHARD_WORLD[0])]
    reset_launches(port)
    call_ms, got = timed_frames(torch, lambda i: fn(calls[i]), len(calls))
    report["playback_launches"] = read_launches(port)
    single = port.runtime.make_playback_fn(editor.objects["main"], cam, pcfg, (1.0, 1.0, 1.0))
    errs = []
    with torch.no_grad():
        for c, imgs in zip(calls, got):
            for v_def, img in zip(c, imgs):
                want = single(v_def)
                assert int(want.tile_overflow) == 0 and int(want.rect_overflow) == 0
                errs.append((img - want.color).abs().max().item())
    report["playback"] = dict(frames=len(errs), max_abs=max(errs),
                              call_ms=[round(x, 2) for x in call_ms],
                              launches=report["playback_launches"])
    assert max(errs) <= 2e-5, errs
    assert report["playback_launches"] == {"K1": len(calls), "K2": 0, "K3": 0}
    lap("sharded playback")
    report["ok"] = True
    with open(os.path.join(work, f"rank{rank}.json"), "w") as fh:
        json.dump(report, fh)
    port.multihost.barrier()
    dist.destroy_process_group()
    return 0


# ------------------------------------------------------------------ phase 10g

def emulated_rank(torch, port, shard, rt, ds, cam_idx, bg):
    """One rank's device work of a 4-way Gaussian-table shard in this process
    (`emulate_d=4`: rank 0's own buckets of view cam_idx stand in for the
    received ones), forward and backward of an L1 sum against the first
    band's rows, host clock ending in `synchronize()`, after one warm call."""
    tr = port.trainer.MeshTrainer(*icosphere(PROXY_SUBDIV), ds,
                                  port.config.OptimizationParams(),
                                  dataclasses.replace(rt, shard_gaussians=0),
                                  spatial_lr_scale=SHARD_LR_SCALE, init_target=0,
                                  max_sh_degree=SH_DEGREE)
    tr.restore(shard)
    cfg, cam = tr.raster_cfg(), ds.camera(cam_idx)
    cap = port.gauss_shard.send_capacity(cfg, tr.model.capacity, GSHARD_WORLD)
    gt = ds.target(cam_idx, bg)
    params = list(tr.model.params().values())
    counts = []

    def call():
        arrays = port.render.mesh_model_arrays(tr.model, cam, SH_DEGREE)
        out = port.gauss_shard.rasterize_band_gauss_sharded(
            arrays, cam, cfg, None, cap, bg, emulate_d=GSHARD_WORLD)
        rows = out.color.shape[1]
        torch.autograd.grad((out.color - gt[:, :rows]).abs().sum(), params,
                            allow_unused=True)
        counts.append(int(out.num_rendered))

    call()
    torch.cuda.synchronize()
    reset_launches(port)
    ms = []
    for _ in range(EMULATED_CALLS):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    res = dict(gaussians=int(tr.model.alive.sum()), capacity=tr.model.capacity,
               send_capacity=cap, pairs=counts[-1], ms_median=float(np.median(ms)),
               ms=[round(x, 3) for x in ms], launches=read_launches(port))
    assert res["launches"] == {"K1": EMULATED_CALLS, "K2": EMULATED_CALLS,
                               "K3": 2 * EMULATED_CALLS}, res
    log("[gshard] emulated rank of 4: " + json.dumps(res))
    return res


def gshard_inputs(torch, port, trainer, tmpdir):
    """10g's inputs: the phase-6 student's table dealt over GSHARD_WORLD
    shards, the single-process step 1 on it, written for the ranks; one
    emulated rank timed. -> {work, emulated, prep_s}."""
    t_phase = time.perf_counter()
    lap = Laps("gshard")
    work = os.path.join(tmpdir, "gshard")
    os.makedirs(work)
    d, ds, bg = GSHARD_WORLD, trainer.ds, trainer.bg_const
    dealt = port.trainer.deal_rows(trainer.capture(), d)
    # twice phase 6's max_per_tile, as 10e: densifies pile pairs into tiles
    rt = dataclasses.replace(trainer.rt, shard_gaussians=d,
                             max_per_tile=2 * trainer.rt.max_per_tile)
    single = port.trainer.MeshTrainer(*icosphere(PROXY_SUBDIV), ds, trainer.opt,
                                      dataclasses.replace(rt, shard_gaussians=0),
                                      spatial_lr_scale=SHARD_LR_SCALE, init_target=0,
                                      max_sh_degree=SH_DEGREE)
    single.restore(dealt)
    m = single.step(0, bg)
    ref = dict(loss=float(m["loss"]),
               params={k: v.detach().cpu() for k, v in single.model.params().items()},
               grad_accum=single.model.state.grad_accum.cpu(),
               denom=single.model.state.denom.cpu())
    del single
    lap("deal and single step")
    torch.save(dict(state=dealt, opt=dataclasses.asdict(trainer.opt),
                    rt=dataclasses.asdict(rt), cam=0,
                    data={k: getattr(ds, k).cpu() for k in ("view", "proj", "campos",
                                                            "tanfovx", "tanfovy",
                                                            "images")},
                    size=(ds.width, ds.height)), os.path.join(work, "inputs.pt"))
    torch.save(ref, os.path.join(work, "reference.pt"))
    lap("inputs saved")
    emulated = emulated_rank(torch, port, port.checkpoint.shard_rows(dealt, 0, d), rt,
                             ds, 0, bg)
    lap("emulated rank")
    return dict(work=work, emulated=emulated, prep_s=time.perf_counter() - t_phase)


def gshard_checks(g, backend, cards, wall):
    """10g's rank reports checked -> (results, launches summed over the
    ranks, the received band kernels of the rank that received the most
    pairs (K1, K2, the receiver's K3), that rank's owner K3)."""
    t0 = time.perf_counter()
    d = GSHARD_WORLD
    reports = [json.load(open(os.path.join(g["work"], f"rank{r}.json"))) for r in range(d)]
    r0 = reports[0]
    for rep in reports:
        assert rep["ok"], rep
        assert rep["losses"] == r0["losses"] and rep["densify"] == r0["densify"], rep
        assert rep["pool_hashes"] == r0["pool_hashes"], rep
        assert (rep["backend"], rep["card"]) == (backend, cards[rep["rank"]]), rep
    launches = {k: sum(rep["launches"][k] for rep in reports) for k in ("K1", "K2", "K3")}
    res = dict(world=d, backend=backend, cards=cards, wall_s=wall, emulated=g["emulated"],
               step1=[rep["step1"] for rep in reports], losses=r0["losses"],
               events=r0["events"], densify=r0["densify"],
               pool_hashes_equal=True, resume_equal=[rep["resume_equal"] for rep in reports],
               step_ms_median=[rep["step_ms_median"] for rep in reports],
               exchange_ms=[rep["exchange_ms"] for rep in reports],
               traffic=r0["traffic"], received_live=[rep["received_live"] for rep in reports],
               rank_launches=[rep["launches"] for rep in reports])
    res["phase_s"] = g["prep_s"] + time.perf_counter() - t0
    log("[gshard] " + json.dumps({k: v for k, v in res.items() if k != "losses"}))
    log(f"[gshard] losses {[round(x, 5) for x in r0['losses']]}")
    res["kernel_rank"] = r0["kernel_rank"]
    k1, k2, k3, k3_owner = reports[r0["kernel_rank"]]["kernels"]
    return res, launches, (k1, k2, k3), (None, None, k3_owner)


def gshard_rank(rank, world, work, backend, card):
    """One rank of phase 10g, on `card`, in a `backend` group from a
    FileStore in `work` (`rank_plan`): its shard of the dealt phase-6 state; step 1 against the
    parent's single-process step; GSHARD_STEPS steps with resets and two
    densifies (each checked against a single-process `densify_and_split` of
    the gathered table, the vertex pools' hashes all-gathered); a per-rank
    checkpoint, GSHARD_MORE more steps, and a fresh trainer resumed from the
    checkpoint for as many (the same bits); the exchange alone timed; one
    more step recording the kernels' arguments (the rank that received the
    most pairs holds K1, K2 and both K3 calls against their plain versions).
    Writes `rank<r>.json`."""
    import hashlib

    import torch
    import torch.distributed as dist

    lap = Laps("gshard")
    join_group(rank, world, work, backend, card)
    port = load_port()
    inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    ref = torch.load(os.path.join(work, "reference.pt"), weights_only=False)
    width, height = inp["size"]
    dd = {k: v.cuda() for k, v in inp["data"].items()}
    ds = port.trainer.DeviceDataset(dd["view"], dd["proj"], dd["campos"], dd["tanfovx"],
                                    dd["tanfovy"], dd["images"], None, width, height)
    opt = port.config.OptimizationParams(**inp["opt"])
    rt = port.config.RuntimeParams(**inp["rt"])
    cam = inp["cam"]

    def make_trainer():
        return port.trainer.MeshTrainer(*icosphere(PROXY_SUBDIV), ds, opt, rt,
                                        spatial_lr_scale=SHARD_LR_SCALE, init_target=0,
                                        max_sh_degree=SH_DEGREE)

    tr = make_trainer()
    tr.restore(port.checkpoint.shard_rows(inp["state"], rank, world))
    del inp
    group = tr.mesh.tile_group
    c = tr.model.capacity
    report = dict(rank=rank, ok=False, backend=dist.get_backend(),
                  card=torch.cuda.current_device())

    def gather_equal(x):
        out = [None] * world
        dist.all_gather_object(out, x)
        return out

    # step 1 against the single-process step on the same camera
    torch.cuda.synchronize()
    reset_launches(port)
    m1 = tr.step(cam, tr.bg_const)
    torch.cuda.synchronize()
    step1_launches = read_launches(port)
    params = tr.model.params()
    rows = slice(rank * c, (rank + 1) * c)
    rel = {k: float((params[k].detach().cpu() - ref["params"][k][rows]).abs().max()
                    / ref["params"][k].abs().max().clamp(min=1e-30)) for k in params}
    st = tr.model.state
    report["step1"] = dict(
        loss=float(m1["loss"]), ref_loss=ref["loss"],
        loss_rel=abs(float(m1["loss"]) - ref["loss"]) / abs(ref["loss"]),
        param_rel=max(rel.values()), param_rel_by_leaf=rel,
        grad_accum_abs=float((st.grad_accum.cpu() - ref["grad_accum"][rows]).abs().max()),
        denom_equal=bool(torch.equal(st.denom.cpu(), ref["denom"][rows])),
        launches=step1_launches, overflow=int(m1["overflow"]))
    s1 = report["step1"]
    assert s1["loss_rel"] <= 1e-4 and s1["param_rel"] <= 5e-4, s1
    assert s1["grad_accum_abs"] <= 1e-5 and s1["denom_equal"], s1
    assert step1_launches == {"K1": 1, "K2": 1, "K3": 2}, step1_launches
    assert s1["overflow"] == 0, s1
    lap("join, load, step 1")
    slots = world * tr.send_capacity()
    # per step: the metadata (2 int32) and the feature rows (16 f32) forward,
    # the feature cotangents back
    report["traffic"] = dict(send_capacity=tr.send_capacity(), slots_per_rank=slots,
                             bytes_sent_per_rank_step=slots * (8 + 64 + 64))

    # GSHARD_STEPS steps with a reset at 2, densifies at 3 and 6, a reset at 6
    tr.global_it = 0          # the schedule below counts from here
    tr.opt = dataclasses.replace(opt, densify_from_iter=2, densification_interval=3,
                                 densify_until_iter=GSHARD_STEPS, opacity_reset_interval=6)
    densify, checks, pool_hashes = tr.densify, [], []

    def densify_checked():
        # a threshold at which no per-shard cap binds (the JAX contract's
        # condition), the same on every rank: from the gathered statistics
        whole = tr.whole_model()
        g = port.densify.grads_avg(whole.state)
        thr = float(torch.topk(g[whole.alive], GSHARD_HOT).values[-1])
        tr.opt = dataclasses.replace(tr.opt, densify_grad_threshold=thr)
        mu, nu = ({k: torch.cat(port.sharding.all_gather(v, group)) for k, v in t.items()}
                  for t in (tr.adam.mu, tr.adam.nu))
        max_split = port.densify.round_up(max(256, whole.capacity // 16), 256)
        want = port.densify.densify_and_split(whole, mu, nu, g, thr, 5, max_split)
        del whole, mu, nu
        got = densify()
        checks.append(dict(iteration=tr.global_it, threshold=thr, n_split=got,
                           single_n_split=want.n_split, single_dropped=want.dropped,
                           capacity=tr.model.capacity))
        assert got == want.n_split and want.dropped == 0 and tr.model.capacity == c, checks
        return got

    tr.densify = densify_checked
    losses, times = [], []
    n_events = [0]
    clock = [time.perf_counter()]

    def on_step(m):
        torch.cuda.synchronize()
        now = time.perf_counter()
        times.append((now - clock[0]) * 1e3)
        losses.append(m["loss"])
        assert m["overflow"] == 0 and m["send_overflow"] == 0, m
        if len(tr.events) > n_events[0]:
            n_events[0] = len(tr.events)
            pool = tr.model.mesh_v
            h = hashlib.sha256(pool.v.cpu().numpy().tobytes() + str(pool.count).encode())
            got = gather_equal(h.hexdigest())
            assert len(set(got)) == 1, got
            pool_hashes.append(got[0])
        clock[0] = time.perf_counter()

    reset_launches(port)
    tr.train(GSHARD_STEPS, log_every=1, callback=on_step)
    kinds = [(it, kind) for it, kind, _ in tr.events]
    assert kinds == [(2, "opacity_reset"), (3, "densify"), (6, "densify"),
                     (6, "opacity_reset")], kinds
    assert all(math.isfinite(x) for x in losses), losses
    lap(f"{GSHARD_STEPS} steps")

    # a per-rank checkpoint; GSHARD_MORE more steps; a fresh trainer resumed
    path = tr.save_ckpt(os.path.join(work, "ckpt", "chkpnt.ckpt"))
    tr.train(GSHARD_MORE, log_every=1, callback=on_step)
    resumed = make_trainer()
    resumed.opt = tr.opt
    resumed.load_ckpt(os.path.join(work, "ckpt", "chkpnt.ckpt"))
    resumed.train(GSHARD_MORE, log_every=1000)
    launches = read_launches(port)
    steps = 1 + GSHARD_STEPS + 2 * GSHARD_MORE
    assert launches == {"K1": GSHARD_STEPS + 2 * GSHARD_MORE,
                        "K2": GSHARD_STEPS + 2 * GSHARD_MORE,
                        "K3": 2 * (GSHARD_STEPS + 2 * GSHARD_MORE)}, launches
    equal = state_hash(resumed) == state_hash(tr)
    assert all(gather_equal(equal)), "a resumed shard differs from the uninterrupted run"
    del resumed
    lap("checkpoint and resume")
    report.update(losses=losses, events=tr.events, densify=checks, pool_hashes=pool_hashes,
                  resume_equal=equal, checkpoint=sorted(os.listdir(path)),
                  launches={k: launches[k] + step1_launches[k] for k in launches},
                  steps=steps, step_ms_median=float(np.median(times)),
                  step_ms=[round(x, 1) for x in times])

    # the exchange alone: the step's three all_to_all calls on buffers of its size
    meta = torch.zeros((slots, 2), dtype=torch.int32, device="cuda")
    feat = torch.zeros((slots, 16), device="cuda")
    ex = []
    for _ in range(EXCHANGE_REPS):
        port.multihost.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        port.sharding.all_to_all(meta, group)
        port.sharding.all_to_all(feat, group)
        port.sharding.all_to_all(feat, group)
        torch.cuda.synchronize()
        ex.append((time.perf_counter() - t0) * 1e3)
    report["exchange_ms"] = float(np.median(ex))
    del meta, feat
    lap("exchange alone")

    # one more step recording the kernels' arguments; the rank whose band
    # received the most pairs checks them (a band may hold none of the object)
    seen = capture_step(torch, port, tr, cam)
    report["received_live"] = int(seen["K1"][1].shape[0])
    received = gather_equal(report["received_live"])
    report["kernel_rank"] = int(np.argmax(received))
    kernels = [None] * 4
    if rank == report["kernel_rank"]:
        k1, _, _, blended = check_k1(torch, port.tile_blend, seen["K1"],
                                     rt.max_per_tile)
        rows_, grouped_pos, seg_starts = seen["K3"]
        k2, k3 = check_k2_k3(torch, port, seen["K2"], grouped_pos, seg_starts, blended,
                             step_rows=rows_)
        k3_owner = check_k3(torch, port.segsum, *seen["K3_owner"])
        kernels = [k1, k2, k3, k3_owner]
        for key, r in zip(("K1", "K2", "K3 receiver", "K3 owner"), kernels):
            log(f"[gshard] {key} at a received band's shapes: " + json.dumps(r))
    report["kernels"] = kernels
    port.multihost.barrier()
    lap("kernels")
    report["ok"] = True
    with open(os.path.join(work, f"rank{rank}.json"), "w") as fh:
        json.dump(report, fh)
    port.multihost.barrier()
    dist.destroy_process_group()
    return 0


# ------------------------------------------------------------------ phase 11

QUALITY_MODES = ("GM_QUALITY_SMALL", "GM_QUALITY_PROTOCOL", "GM_QUALITY_ITERS")


def load_tool(*path):
    """A tool of the repository (a path under its root) loaded by path."""
    import importlib.util

    full = os.path.join(os.path.dirname(os.path.abspath(__file__)), *path)
    spec = importlib.util.spec_from_file_location(
        os.path.splitext(path[-1])[0] + "_smoke", full)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def load_quality_tool(mode):
    """tools/quality_run_torch.py loaded afresh with its mode's environment
    ("GM_QUALITY_SMALL" or "GM_QUALITY_PROTOCOL" set to 1, the others unset)."""
    saved = {k: os.environ.pop(k, None) for k in QUALITY_MODES}
    os.environ[mode] = "1"
    try:
        tool = load_tool("tools", "quality_run_torch.py")
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    return tool


def quality_trainer(torch, port, tool):
    """A `MeshTrainer` at the PROTOCOL run's shapes: the tool's icosphere-4
    teacher over white as QUALITY_STEP_VIEWS ground-truth views at its size,
    the uv-sphere proxy (1,600 faces -> 102,400 Gaussians), and the flags the
    tool hands `train_mesh`, parsed by the port's own parser."""
    args, _ = port.cli_common.base_parser("quality step").parse_known_args(
        tool.train_args("data", "model", "proxy.obj"))
    opt = port.config.extract(port.config.OptimizationParams, args)
    rt = port.config.extract(port.config.RuntimeParams, args)
    teacher = tool.make_teacher(4, "cuda")
    cfg = port.rasterize.RasterizerConfig(tool.W, tool.H, tool.TEACHER_MAX_PER_TILE)
    n_total = tool.N_CAMS + max(4, tool.N_CAMS // 6)
    cams = []
    with torch.no_grad():
        for i in range(QUALITY_STEP_VIEWS):
            R, T, _ = tool.pose(i, n_total)
            cam = port.cameras.Camera(uid=i, R=R, T=T, fovx=tool.FOVX, fovy=tool.FOVX,
                                      image=None, width=tool.W, height=tool.H)
            out = port.render.render(port.render.mesh_model_arrays(
                teacher, cam.arrays("cuda"), 0), cam.arrays("cuda"), cfg,
                torch.ones(3, device="cuda"))
            cam.image = (port.cli_common.to_uint8(out.color).transpose(2, 0, 1)
                         .astype(np.float32) / 255.0)
            cams.append(cam)
    ds = port.trainer.DeviceDataset.from_cameras(cams, device="cuda")
    v, f = tool.proxy_mesh()
    extent = port.readers.nerfpp_norm(cams)["radius"]
    trainer = port.trainer.MeshTrainer(v, f, ds, opt, rt, spatial_lr_scale=extent,
                                       init_target=tool.INIT_TARGET,
                                       max_sh_degree=int(args.sh_degree))
    trainer.sh_degree = trainer.max_sh_degree    # the state after iteration 2000
    return trainer


def quality_step(torch, port, trainer, label):
    """K1, K2 and K3 held against their plain versions on the arguments of
    one more step of `trainer`, timed and bounded as in phase 5."""
    seen = capture_step(torch, port, trainer)
    k1, _, _, blended = check_k1(torch, port.tile_blend, seen["K1"],
                                 trainer.rt.max_per_tile)
    rows, grouped_pos, seg_starts = seen["K3"]
    k2, k3 = check_k2_k3(torch, port, seen["K2"], grouped_pos, seg_starts,
                         blended, step_rows=rows)
    feat, _, _, counts = seen["K1"][:4]
    log(f"[quality] {label}: {int(trainer.model.alive.sum())} alive of "
        f"{feat.shape[0]} rows, {int(counts.sum())} pairs, largest tile "
        f"{int(counts.max())} (max_per_tile {trainer.rt.max_per_tile})")
    for key, r in (("K1", k1), ("K2", k2), ("K3", k3)):
        log(f"[quality] {key} at the {label}'s shapes: " + json.dumps(r))
    return k1, k2, k3


def phase_quality(torch, port, tmpdir):
    """11. The config-2 quality protocol at SMALL scale through
    `tools/quality_run_torch.py`, once per seed; then the quality step."""
    t_phase = time.perf_counter()
    tool = load_quality_tool("GM_QUALITY_SMALL")
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "results", "config2_quality_smoke.json")) as fh:
        ref = json.load(fh)                  # the JAX package's SMALL run (CPU)
    first, last = str(tool.EVAL_ITERS[0]), str(tool.ITERS)
    ref_psnr = ref["trajectory"][last]["PSNR"]
    n_total = tool.N_CAMS + max(4, tool.N_CAMS // 6)
    n_test = sum(1 for i in range(n_total) if i % 8 == 7)
    # K1: each step, each teacher view, each test view of train_mesh's evals,
    # of render's and twice of the clamp report's (clamped and unclamped);
    # K2 and K3: each step
    want = {"K1": tool.ITERS + n_total + 4 * len(tool.EVAL_ITERS) * n_test,
            "K2": tool.ITERS, "K3": tool.ITERS}
    runs, launches = [], {"K1": 0, "K2": 0, "K3": 0}
    for seed in QUALITY_SEEDS:
        work = os.path.join(tmpdir, f"quality_seed{seed}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reset_launches(port)                             # main path starts
        art = tool.main([work, "--device", "cuda", "--seed", str(seed),
                         "--out", os.path.join(work, "quality.json")])
        torch.cuda.synchronize()
        got = read_launches(port)                        # main path ends
        run = dict(seed=seed, seconds=time.perf_counter() - t0, launches=got,
                   train_seconds=art["train_seconds"],
                   iters_per_second=art["iters_per_second"],
                   psnr={it: r["PSNR"] for it, r in art["trajectory"].items()},
                   ssim={it: r["SSIM"] for it, r in art["trajectory"].items()},
                   lpips_uncalibrated={it: r["LPIPS_uncalibrated"]
                                       for it, r in art["trajectory"].items()},
                   n_gauss_final=art["n_gauss_final"], overflow=art["overflow"],
                   host_events={k: {"count": v["count"], "total_ms": v["total_ms"]}
                                for k, v in art["host_events"].items()})
        log("[quality] SMALL run: " + json.dumps(run))
        runs.append(run)
        assert got == want, (got, want)
        assert art["losses_finite"], seed
        assert all(math.isfinite(x) for r in art["trajectory"].values()
                   for x in (r["PSNR"], r["SSIM"], r["LPIPS_uncalibrated"])), art
        assert run["psnr"][last] > run["psnr"][first], run["psnr"]
        for k in launches:
            launches[k] += got[k]
    final = [r["psnr"][last] for r in runs]
    log(f"[quality] SMALL test PSNR at {last} by seed {QUALITY_SEEDS}: {final} "
        f"(spread {max(final) - min(final):.4f} dB) against the JAX package's "
        f"{ref_psnr:.4f} ({ref['backend']}); bar {QUALITY_BAR_DB} dB")
    for seed, psnr in zip(QUALITY_SEEDS, final):
        if abs(psnr - ref_psnr) > QUALITY_BAR_DB:
            raise AssertionError(f"seed {seed}: SMALL test PSNR {psnr:.4f} is more "
                                 f"than {QUALITY_BAR_DB} dB from the JAX package's "
                                 f"{ref_psnr:.4f}")

    t0 = time.perf_counter()
    trainer = quality_trainer(torch, port, load_quality_tool("GM_QUALITY_PROTOCOL"))
    kernels = quality_step(torch, port, trainer, "quality step")
    res = dict(runs=runs, reference_psnr=ref_psnr, final_psnr=final,
               spread_db=max(final) - min(final),
               quality_step_s=time.perf_counter() - t0,
               phase_s=time.perf_counter() - t_phase)
    return res, launches, kernels


class Tee:
    """A stdout that also keeps what is written."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()

    def lines(self):
        return "".join(self.parts).strip().splitlines()


def run_tool(tool, argv, label):
    """tool.main(argv) in this process, its output echoed and kept -> (its
    result, its last output line)."""
    tee = Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        res = tool.main(argv)
    log(f"[tools] {label}: {time.perf_counter() - t0:.1f} s")
    return res, tee.lines()[-1]


def phase_tools(torch, port, tmpdir):
    """12. The measurement tools in-process on the card at their full width:
    `bench_torch.py` (10 steps), `tools/profile_raster_torch.py --prefix`
    (TOOL_REPS calls a row) and `tools/bench_playback_torch.py` (TOOL_FRAMES
    frames, TOOL_STEPS4 config-4 steps), artifacts in the phase's directory;
    then K1, K2 and K3 against their plain versions on one bench step."""
    t_phase = time.perf_counter()
    bench = load_tool("bench_torch.py")
    prof = load_tool("tools", "profile_raster_torch.py")
    play = load_tool("tools", "bench_playback_torch.py")
    torch.cuda.synchronize()
    reset_launches(port)                                 # main path starts
    b, b_line = run_tool(bench, [], "bench_torch.py")
    p, _ = run_tool(prof, ["--prefix", "--reps", str(TOOL_REPS),
                           "--out", os.path.join(tmpdir, "profile_raster_torch.json")],
                    "profile_raster_torch.py --prefix")
    pb, pb_line = run_tool(play, ["--frames", str(TOOL_FRAMES), "--steps4", str(TOOL_STEPS4),
                                  "--out", os.path.join(tmpdir, "playback_torch.json")],
                           "bench_playback_torch.py")
    torch.cuda.synchronize()
    launches = read_launches(port)                       # main path ends
    line, pb_json = json.loads(b_line), json.loads(pb_line)
    with open(os.path.join(tmpdir, "profile_raster_torch.json")) as fh:
        p_json = json.load(fh)
    d = b["detail"]
    res = dict(bench_step_ms=d["step_ms"], bench_mpix_s=b["value"],
               bench_num_rendered=d["num_rendered"],
               prefix_b7_host_ms=p["prefix"]["b7_host_ms"],
               prefix_f7_num_rendered=p["prefix"]["f7_num_rendered"],
               config3_fps=pb["config3"]["fps"], config5_fps=pb["config5"]["fps"],
               config4_step_ms=pb["config4"]["train_step_ms"], launches=launches)
    log("[tools] " + json.dumps(res))
    assert line == json.loads(json.dumps(b)) and "error" not in line, line
    assert pb_json["metric"] == "playback_fps_1080p", pb_json
    assert p_json["prefix"]["b7_host_ms"] == p["prefix"]["b7_host_ms"]
    assert d["overflow"] == 0, d
    assert d["launches_per_step"] == {"K1": 1, "K2": 1, "K3": 1}, d
    assert d["num_rendered"] == p["prefix"]["f7_num_rendered"], res
    for key in ("config3", "config5"):
        assert pb[key]["tile_overflow_max"] == 0 and pb[key]["rect_overflow_max"] == 0
    assert pb["config4"]["tile_overflow"] == 0 and pb["config4"]["rect_overflow"] == 0
    assert pb["config3"]["cov_rotation_max"] > 0, pb["config3"]
    assert all(launches[k] > 0 for k in launches), launches

    t0 = time.perf_counter()
    w = bench.make_workload(bench.WIDTH, bench.HEIGHT, bench.N_GAUSS)
    seen = capture_calls(torch, port, lambda: bench.fwd_bwd(w))
    k1, _, _, blended = check_k1(torch, port.tile_blend, seen["K1"], w.cfg.max_per_tile)
    rows, grouped_pos, seg_starts = seen["K3"]
    k2, k3 = check_k2_k3(torch, port, seen["K2"], grouped_pos, seg_starts, blended,
                         step_rows=rows)
    for key, r in (("K1", k1), ("K2", k2), ("K3", k3)):
        log(f"[tools] {key} at the bench step's shapes: " + json.dumps(r))
    res.update(kernel_check_s=time.perf_counter() - t0,
               phase_s=time.perf_counter() - t_phase)
    return res, launches, (k1, k2, k3)


def phase_scaling(torch, port, tmpdir):
    """13. The two scaling tools in-process on the card at full width:
    `tools/bench_scaling_torch.py` (D in SCALING_D) and
    `tools/bench_sharded_torch.py`, SCALING_STEPS steps an item, artifacts in
    the phase's directory; then K1, K2 and K3 against their plain versions
    at the D = max(SCALING_D) critical band's step ("scaling band") and at
    that D's critical emulated rank at the design's send capacity ("scaling
    gshard", its receiver K3 and, as "scaling gshard owner", the owner's)."""
    t_phase = time.perf_counter()
    bench = load_tool("bench_torch.py")
    scaling = load_tool("tools", "bench_scaling_torch.py")
    sharded = load_tool("tools", "bench_sharded_torch.py")
    steps = ["--steps", str(SCALING_STEPS)]
    torch.cuda.synchronize()
    reset_launches(port)                                 # main path starts
    sc, sc_line = run_tool(scaling, steps + [
        "--d_list", *map(str, SCALING_D), "--profile", "critical",
        "--out", os.path.join(tmpdir, "scaling_torch.json")], "bench_scaling_torch.py")
    log(f"[scaling-s] bench_scaling_torch.py {time.perf_counter() - t_phase:.1f}")
    sh, sh_line = run_tool(sharded, steps + [
        "--out", os.path.join(tmpdir, "sharded_bench_torch.json")],
        "bench_sharded_torch.py")
    torch.cuda.synchronize()
    launches = read_launches(port)                       # main path ends
    line = json.loads(sc_line)
    for path, art in (("scaling_torch.json", sc), ("sharded_bench_torch.json", sh)):
        with open(os.path.join(tmpdir, path)) as fh:
            assert json.load(fh) == json.loads(json.dumps(art)), path
    assert json.loads(sh_line) == json.loads(json.dumps(sh))
    assert line["metric"] == "scaling_efficiency_8dev_model", line
    assert not torch.distributed.is_initialized()
    d_top = max(SCALING_D)
    tile, gauss = sc["tile_bands"], sc["gauss_shard_bands"]
    assert sc["plain_step"]["num_rendered"] == BENCH_PAIRS, sc["plain_step"]
    assert [b["num_rendered"] for b in tile["1"]["bands"]] == [BENCH_PAIRS], tile["1"]
    for d, rec in tile.items():
        assert sum(b["num_rendered"] for b in rec["bands"]) == BENCH_PAIRS, (d, rec)
        assert [b["num_rendered"] for b in rec["bands"]] == rec["pair_hist"], (d, rec)
        for b in rec["bands"]:
            assert b["tile_overflow"] == b["rect_overflow"] == b["pair_overflow"] == 0, b
    for d, rec in gauss.items():
        for label in ("design", "jax_live"):
            assert all(r["send_overflow"] == 0 for r in rec[label]["ranks"]), (d, label)
    for name in ("tile", "gauss"):
        a = sh["steps"][name]["agreement"]
        assert a["loss_rel"] <= RANK_LOSS_REL and a["grad_rel"] <= RANK_GRAD_REL, (name, a)
        assert sh["steps"][name]["num_rendered"] == BENCH_PAIRS, sh["steps"][name]
    first = sc["sharded_train_step"]["sharded_1x1"]["first_step"]
    assert first["loss_rel"] <= RANK_LOSS_REL and first["param_rel"] <= RANK_PARAM_REL, first
    assert all(launches[k] > 0 for k in launches), launches
    res = dict(plain_step_ms=sc["plain_step"]["host_ms"],
               plain_busy_ms=sc["plain_step"]["busy_ms"],
               critical_band_ms={d: r["critical_ms"] for d, r in tile.items()},
               critical_band_busy_ms={d: r["critical_busy_ms"] for d, r in tile.items()},
               gshard_critical_ms={d: r["design"]["critical_ms"] for d, r in gauss.items()},
               gshard_critical_busy_ms={d: r["design"]["critical_busy_ms"]
                                        for d, r in gauss.items()},
               efficiency=line["value"], train_ratio_host=sc["sharded_train_step"][
                   "ratio_host"], tile_1x1_overhead=sh["steps"]["tile"]["overhead_host"],
               gauss_1x1_overhead=sh["steps"]["gauss"]["overhead_host"],
               replicated_ms=sh["replicated"]["host_ms"], launches=launches)
    log("[scaling] " + json.dumps(res))

    t0 = time.perf_counter()
    w = bench.make_workload(bench.WIDTH, bench.HEIGHT, bench.N_GAUSS)
    band = tile[str(d_top)]
    k = band["critical_index"]
    cfg = scaling.band_config(w.cfg, band)
    seen = capture_calls(torch, port, scaling.band_call(w, cfg, band["gy_local"],
                                                        k * band["gy_local"]))
    k1, _, _, blended = check_k1(torch, port.tile_blend, seen["K1"], cfg.max_per_tile)
    rows, grouped_pos, seg_starts = seen["K3"]
    k2, k3 = check_k2_k3(torch, port, seen["K2"], grouped_pos, seg_starts, blended,
                         step_rows=rows)
    kernels_band = (k1, k2, k3)
    g = gauss[str(d_top)]
    r = g["design"]["critical_index"]
    seen = capture_calls(torch, port, scaling.gshard_call(
        w, d_top, scaling.shard_inputs(w, d_top, r), g["send_capacity"]["design"]))
    k1, _, _, blended = check_k1(torch, port.tile_blend, seen["K1"], w.cfg.max_per_tile)
    rows, grouped_pos, seg_starts = seen["K3"]
    k2, k3 = check_k2_k3(torch, port, seen["K2"], grouped_pos, seg_starts, blended,
                         step_rows=rows)
    k3_owner = check_k3(torch, port.segsum, *seen["K3_owner"])
    assert k3["gaussians"] == d_top * g["send_capacity"]["design"], k3
    kernels_gshard = (k1, k2, k3)
    for label, ks in ((f"band {k} of {d_top}", kernels_band),
                      (f"emulated rank {r} of {d_top}", kernels_gshard + (k3_owner,))):
        for key, kr in zip(("K1", "K2", "K3", "K3 owner"), ks):
            log(f"[scaling] {key} at the {label}'s shapes: " + json.dumps(kr))
    res.update(kernel_check_s=time.perf_counter() - t0,
               phase_s=time.perf_counter() - t_phase)
    log(f"[scaling-s] both tools {t0 - t_phase:.1f}; kernel checks "
        f"{res['kernel_check_s']:.1f}")
    return res, launches, kernels_band, kernels_gshard, (None, None, k3_owner)


def quality_step_main(work):
    """`python3 chip_smoke.py --quality-step WORK`: the quality step on the
    table of WORK's newest checkpoint (a PROTOCOL run of
    tools/quality_run_torch.py) at the run's `max_per_tile`, K1-K3 against
    their plain versions there."""
    import torch

    smi = phase_card(torch)
    port = load_port()
    phase_build(port._cuda)
    trainer = quality_trainer(torch, port, load_quality_tool("GM_QUALITY_PROTOCOL"))
    ckpt = port.cli_train_mesh.latest_checkpoint(os.path.join(work, "model"))
    if ckpt is None:
        raise SystemExit(f"chip_smoke --quality-step: no checkpoint under {work}/model")
    trainer.load_ckpt(ckpt)
    # the run's own clamp (`--max_per_tile` of the tool, in its cfg_args.json)
    saved = port.config.load_cfg(os.path.join(work, "model")).get("runtime", {})
    trainer.rt = dataclasses.replace(
        trainer.rt, max_per_tile=saved.get("max_per_tile", trainer.rt.max_per_tile))
    k1, k2, k3 = quality_step(torch, port, trainer, f"quality step at {ckpt}")
    print(json.dumps({"quality_step": {"checkpoint": ckpt, "K1": k1, "K2": k2,
                                       "K3": k3}}))
    print(smi)
    return 0


def load_port():
    """The port's modules the phases use, as one namespace."""
    from gaussianmesh_tpu_torch import config
    from gaussianmesh_tpu_torch.io import gaussian_ply
    from gaussianmesh_tpu_torch.models import mesh_gaussians, render
    from gaussianmesh_tpu_torch.ops import (_cuda, binning, oracle, preprocess,
                                            rasterize, segsum, tile_blend)
    from gaussianmesh_tpu_torch.train import densify, trainer
    from gaussianmesh_tpu_torch.utils import graphics, maths

    from gaussianmesh_tpu_torch import scene
    from gaussianmesh_tpu_torch.cli import common as cli_common, edit as cli_edit
    from gaussianmesh_tpu_torch.cli import render as cli_render
    from gaussianmesh_tpu_torch.cli import train_bg as cli_train_bg
    from gaussianmesh_tpu_torch.cli import train_mesh as cli_train_mesh
    from gaussianmesh_tpu_torch.data import cameras, readers
    from gaussianmesh_tpu_torch.edit import pose_paths, runtime
    from gaussianmesh_tpu_torch.io import colmap, mesh as mesh_io, png
    from gaussianmesh_tpu_torch.models import gaussians
    from gaussianmesh_tpu_torch.train import bg_trainer
    from gaussianmesh_tpu_torch.utils import sh

    from gaussianmesh_tpu_torch.cli import full_eval as cli_full_eval
    from gaussianmesh_tpu_torch.cli import metrics as cli_metrics
    from gaussianmesh_tpu_torch.eval import lpips
    from gaussianmesh_tpu_torch.io import bmp, gif, jpeg, resample, tiff, vp8l, webp
    from gaussianmesh_tpu_torch.io import pcx, pnm, qoi, sgi, tga
    from gaussianmesh_tpu_torch.io import icns, ico
    from gaussianmesh_tpu_torch.io import msp, psd, sun, xbm, xpm
    from gaussianmesh_tpu_torch.io import fli, gbr, im, imt, iptc
    from gaussianmesh_tpu_torch.io import bcn, fits, ftex, mcidas, pixar, spider, xvthumb
    from gaussianmesh_tpu_torch.io import blp, dds
    from gaussianmesh_tpu_torch.train import loss

    from gaussianmesh_tpu_torch import viewer
    from gaussianmesh_tpu_torch.edit import deform, native_acap
    from gaussianmesh_tpu_torch.parallel import (edit_step, gauss_shard, multihost,
                                                 sharding, train_step)
    from gaussianmesh_tpu_torch.utils import checkpoint

    return types.SimpleNamespace(
        viewer=viewer, deform=deform, native_acap=native_acap, edit_step=edit_step,
        multihost=multihost, sharding=sharding, train_step=train_step,
        gaussian_ply=gaussian_ply, mesh_gaussians=mesh_gaussians, render=render,
        binning=binning, oracle=oracle, preprocess=preprocess,
        rasterize=rasterize, segsum=segsum, tile_blend=tile_blend,
        graphics=graphics, maths=maths, config=config, trainer=trainer,
        densify=densify, _cuda=_cuda, runtime=runtime, pose_paths=pose_paths,
        cameras=cameras, readers=readers, mesh_io=mesh_io, gaussians=gaussians, sh=sh,
        cli_common=cli_common, cli_edit=cli_edit, cli_train_mesh=cli_train_mesh,
        cli_train_bg=cli_train_bg, cli_render=cli_render, scene=scene, png=png,
        colmap=colmap, bg_trainer=bg_trainer, cli_full_eval=cli_full_eval,
        cli_metrics=cli_metrics, lpips=lpips, jpeg=jpeg, resample=resample, loss=loss,
        tiff=tiff, gif=gif, bmp=bmp, webp=webp, vp8l=vp8l, pnm=pnm, tga=tga, qoi=qoi,
        sgi=sgi, pcx=pcx, ico=ico, icns=icns, sun=sun, msp=msp, xbm=xbm, xpm=xpm, psd=psd,
        fli=fli, gbr=gbr, im=im, imt=imt, iptc=iptc, bcn=bcn, fits=fits, ftex=ftex,
        mcidas=mcidas, pixar=pixar, spider=spider, xvthumb=xvthumb, dds=dds, blp=blp,
        gauss_shard=gauss_shard, checkpoint=checkpoint)


def main() -> int:
    if sys.argv[1:2] == ["--ranks"]:             # a rank of phases 10e / 10f, then 10g
        return ranks_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5],
                          sys.argv[6], int(sys.argv[7]))
    if sys.argv[1:2] == ["--quality-step"]:      # the quality step on a run's table
        return quality_step_main(sys.argv[2])
    import torch

    smi = phase_card(torch)
    port = load_port()
    t_start = time.perf_counter()
    phase_build(port._cuda)
    phase_oracle(torch, port)
    with tempfile.TemporaryDirectory() as tmpdir:
        model, cam, cfg, render_k1, frames = phase_slice(torch, port, tmpdir)
        results, fullscreen = phase_kernels(torch, port, model, cam, cfg)
        train_launches, step_ms, results["train"], student = phase_train(
            torch, port, model)
        train_rt = student.rt
        t_play = time.perf_counter()
        playback, k1_composite, playback_launches = phase_playback(
            torch, port, model, cam, cfg, tmpdir)
        t_play = time.perf_counter() - t_play
        t_pipe = time.perf_counter()
        pipeline, pipeline_launches, results["pipeline"] = phase_pipeline(
            torch, port, model, train_rt, tmpdir)
        t_pipe = time.perf_counter() - t_pipe
        evaluation, eval_launches, results["eval"], eval_scene = phase_eval(
            torch, port, model, train_rt, tmpdir)
        jpeg_s_per_mp = evaluation["jpeg_decode_s_per_mp"]
        reader_views = {}
        progressive, reader_views["9b"] = phase_progressive(torch, port, model, eval_scene,
                                                            tmpdir)
        formats, reader_views["9c"] = phase_formats(torch, port, eval_scene, tmpdir)
        webp_res, reader_views["9d"] = phase_webp(torch, port, eval_scene, tmpdir)
        webp9e = phase_webp_alpha(torch, port, pipeline.pop("config2_scene"),
                                  eval_scene["sched"], jpeg_s_per_mp, tmpdir)
        tiff9f, reader_views["9f"] = phase_tiff_layouts(torch, port, eval_scene,
                                                        jpeg_s_per_mp, tmpdir)
        raw9g, reader_views["9g"] = phase_raw_formats(torch, port, eval_scene,
                                                      jpeg_s_per_mp, tmpdir)
        cont9i, reader_views["9i"] = phase_container_formats(torch, port, eval_scene,
                                                             jpeg_s_per_mp, tmpdir)
        rle9j, reader_views["9j"] = phase_rle_text_formats(torch, port, eval_scene,
                                                           jpeg_s_per_mp, tmpdir)
        raw9k, reader_views["9k"] = phase_raw_sample_formats(torch, port, eval_scene,
                                                             jpeg_s_per_mp, tmpdir)
        tex9l, reader_views["9l"] = phase_sample_texture_formats(torch, port, eval_scene,
                                                                 jpeg_s_per_mp, tmpdir)
        tex9m, reader_views["9m"] = phase_texture_formats(torch, port, eval_scene,
                                                          jpeg_s_per_mp, tmpdir)
        readers, readers_launches = phase_reader_training(torch, port, eval_scene,
                                                          reader_views, tmpdir)
        del eval_scene, reader_views
        t_serve = time.perf_counter()
        lap = Laps("serve")
        acap = phase_acap(torch, port)
        lap("acap")
        viewer, serve_launches = phase_viewer(torch, port, cfg, tmpdir)
        lap("viewer")
        e2e = phase_e2e(torch, tmpdir)
        lap("e2e")
        bands = phase_bands(torch, port, model, cam, cfg)
        lap("bands")
        (shard, shard_launches, results["band"], gshard, gshard_launches, results["gshard"],
         results["gshard_owner"]) = phase_shards(
            torch, port, student,
            dataclasses.replace(cfg, max_per_tile=2 * cfg.max_per_tile), cam, tmpdir)
        lap("10e-10g")
        t_serve = time.perf_counter() - t_serve
        quality, quality_launches, results["quality"] = phase_quality(torch, port, tmpdir)
        tools, tools_launches, results["bench"] = phase_tools(torch, port, tmpdir)
        (scaling, scaling_launches, results["scaling_band"], results["scaling_gshard"],
         results["scaling_gshard_owner"]) = phase_scaling(torch, port, tmpdir)
    results["composite"] = (k1_composite, None, None)
    kernels = kernel_line(results, fullscreen,
                          {"render": {"K1": render_k1, "K2": 0, "K3": 0},
                           "train": train_launches, "playback": playback_launches,
                           "pipeline": pipeline_launches, "eval": eval_launches,
                           "readers": readers_launches,
                           "serve": serve_launches, "shard": shard_launches,
                           "gshard": gshard_launches, "quality": quality_launches,
                           "tools": tools_launches, "scaling": scaling_launches})
    log(f"[done] {time.perf_counter() - t_start:.1f} s; 1080p frame ms mean "
        f"{np.mean(frames):.3f}; 800px train step ms median {np.median(step_ms):.3f}")
    log(f"[done] playback phase {t_play:.1f} s; 1080p playback frame ms mean: "
        f"config 3 {playback['config3']['frame_ms_mean']:.3f}, config 5 "
        f"{playback['config5']['frame_ms_mean']:.3f}")
    log(f"[done] pipeline phase {t_pipe:.1f} s; step ms median: config 2 "
        f"{pipeline['config2']['step_ms_median']:.3f}, config 4 mesh "
        f"{pipeline['config4']['mesh']['step_ms_median']:.3f}, background "
        f"{pipeline['config4']['bg']['step_ms_median']:.3f}")
    log(f"[done] eval phase {evaluation['phase_s']:.1f} s on {smi}: JPEG decode "
        f"{evaluation['jpeg_decode_s_per_mp']:.4f} s/MP (host), resample "
        f"{evaluation['resample_ms_per_image']:.1f} ms per 1920x1080 -> 1600x900 image "
        f"(host), dataset load {evaluation['load_s']:.2f} s, 1600x900 train step ms "
        f"median {evaluation['step_ms_median']:.3f}, LPIPS "
        f"{evaluation['lpips_ms_per_view']:.2f} ms per 1600x900 view; test PSNR "
        f"{evaluation['psnr']:.4f}, SSIM {evaluation['ssim']:.4f}, LPIPS_uncalibrated "
        f"{evaluation['lpips_uncalibrated']:.4f} after {EVAL_ITERS} iterations; the "
        f"object covers {np.mean(evaluation['object_coverage']):.4f} of a test view "
        f"(phase 8's: {np.mean(evaluation['phase8_object_coverage']):.4f}); kernel "
        f"checks {evaluation['kernel_check_s']:.1f} s of the phase")
    codecs = pipeline["png_codecs"]
    log(f"[done] host codecs on {smi}, host CPU: {host_cpu()} (one core a call): JPEG "
        f"decode {evaluation['jpeg_decode_s_per_mp']:.4f} s/MP (plain "
        f"{evaluation['jpeg_decode_plain_s_per_mp']:.4f}); PNG unfilter of an "
        f"{PIPE_SIZE}x{PIPE_SIZE} RGBA view with filtered rows "
        f"{codecs['unfilter_ms_median']:.2f} ms (plain {codecs['unfilter_plain_ms_median']:.1f}), "
        f"its decode {codecs['filtered_decode_ms_median']:.2f} ms (plain "
        f"{codecs['filtered_decode_plain_ms_median']:.1f}); resize 1920x1080 -> 1600x900 "
        f"{evaluation['resample_ms_per_image']:.1f} ms (plain "
        f"{evaluation['resample_plain_ms_per_image']:.1f}); dataset loads: config 2 "
        f"(Blender, {PIPE_VIEWS + PIPE_TEST_VIEWS} PNGs) {pipeline['config2']['load_s']:.2f} s, "
        f"eval ({EVAL_VIEWS} JPEGs at -r -1) {evaluation['load_s']:.2f} s")
    cpu = f"{smi}, host CPU: {host_cpu()} (one core a call)"
    log(f"[done] progressive phase {progressive['phase_s']:.1f} s on {cpu}: "
        f"{progressive['views']} progressive JPEGs at {EVAL_WIDTH}x{EVAL_HEIGHT}, decode "
        f"{progressive['decode_s_per_mp']:.4f} s/MP (the baseline files in the same run "
        f"{progressive['baseline_decode_s_per_mp']:.4f}); at {CROP_9F[0]}x{CROP_9F[1]} C++ "
        f"{progressive['crop_decode_s_per_mp']:.4f}, plain "
        f"{progressive['decode_plain_s_per_mp']:.4f}; write "
        f"{progressive['write_s_per_view']:.3f} s a view; {progressive['lossless_fixtures']} "
        "lossless JPEG fixtures; lossless rows s/MP (x the baseline files), plain / C++ at "
        f"{CROP_9F[0]}x{CROP_9F[1]}, bytes: " + ", ".join(
            f"predictor {p} {r['decode_s_per_mp']:.4f} ({r['decode_vs_baseline_jpeg']:.2f}x), "
            f"{r['plain_vs_cpp']:.1f}, {r['bytes']}" for p, r in
            progressive["lossless"].items())
        + f"; {progressive['arith_fixtures']} arithmetic JPEG fixtures; arithmetic rows s/MP "
        f"(x the baseline files), plain s/MP and plain / C++ at {ARITH_CROP_9B[0]}x"
        f"{ARITH_CROP_9B[1]}, bytes (x the Huffman file), write s: " + ", ".join(
            f"{k} {r['decode_s_per_mp']:.4f} ({r['decode_vs_baseline_jpeg']:.2f}x), "
            f"{r['crop_plain_s_per_mp']:.3f}, {r['plain_vs_cpp']:.1f}, {r['bytes']} "
            f"({r['bytes_vs_huffman']:.3f}x), {r['write_s']:.2f}"
            for k, r in progressive["arith"].items()))
    log(f"[done] formats phase {formats['phase_s']:.1f} s on {cpu}: s/MP C++ / plain by "
        "format " + ", ".join(f"{k} {r['decode_s_per_mp']:.4f} / {r['plain_s_per_mp']:.4f}"
                              for k, r in formats["formats"].items()))
    log(f"[done] WebP phase {webp_res['phase_s']:.1f} s on {cpu}: {webp_res['fixtures']} "
        f"fixtures; s/MP C++ at 1920x1080 / C++ and plain at "
        f"{WEBP_PLAIN_SIZE[0]}x{WEBP_PLAIN_SIZE[1]}, PSNR min by row " + ", ".join(
            f"{k} {r['decode_s_per_mp']:.4f} / {r['small_decode_s_per_mp']:.4f} and "
            f"{r['plain_s_per_mp']:.3f}, {r['psnr_min']:.2f} dB"
            for k, r in webp_res["rows"].items()))
    log(f"[done] WebP alpha phase {webp9e['phase_s']:.1f} s on {cpu}: "
        f"{webp9e['fixtures']} fixtures; by row s/MP at {PIPE_SIZE}x{PIPE_SIZE} (x phase 9's "
        f"baseline JPEG), plain / C++ at {WEBP_9E_PLAIN}^2, bytes a view, write s: " + ", ".join(
            f"{k} {r['decode_s_per_mp']:.4f} ({r['decode_vs_baseline_jpeg']:.2f}x), "
            f"{r['plain_vs_cpp']:.0f}, {r['bytes_mean']:.0f}, {r['write_s']:.3f}"
            for k, r in webp9e["rows"].items())
        + f"; the Blender set's training dataset {webp9e['load_s']:.2f} s")
    for name, r9 in (("TIFF layouts", tiff9f), ("PNM / TGA / QOI / SGI / PCX", raw9g),
                     ("DIB / ICO / CUR / DCX / ICNS", cont9i),
                     ("SUN / MSP / XBM / XPM / PSD", rle9j),
                     ("FLI / IPTC / IM / IMT / GBR", raw9k),
                     ("PIXAR / MCIDAS / XVTHUMB / FITS / SPIDER / FTEX", tex9l),
                     ("DDS / BLP", tex9m)):
        walk = (f" (ICNS run-length walk plain / C++ {r9['icns_rle_plain_vs_cpp']:.1f})"
                if "icns_rle_plain_vs_cpp" in r9 else "")
        if "sun_rle_plain_vs_cpp" in r9:
            walk = (f" (walks plain / C++: gm_sun_rle {r9['sun_rle_plain_vs_cpp']:.1f}, "
                    f"gm_msp_rle {r9['msp_rle_plain_vs_cpp']:.1f})")
        if "fli_frame_plain_vs_cpp" in r9:
            walk = f" (gm_fli_frame plain / C++ {r9['fli_frame_plain_vs_cpp']:.1f})"
        if "bc1_plain_vs_cpp" in r9:
            walk = f" (gm_bc1_decode plain / C++ {r9['bc1_plain_vs_cpp']:.1f})"
        if "bcn_plain_vs_cpp" in r9:
            walk = " (gm_bcn_decode plain / C++ " + ", ".join(
                f"{k} {v:.1f}" for k, v in r9["bcn_plain_vs_cpp"].items()) + ")"
        log(f"[done] {name} phase {r9['phase_s']:.1f} s on {cpu}: {r9['fixtures']} "
            f"fixtures{walk}; by row s/MP at {EVAL_WIDTH}x{EVAL_HEIGHT} (x phase 9's baseline "
            f"JPEG), plain / C++ at {CROP_9F[0]}x{CROP_9F[1]}, bytes a view (x the JPEG's), "
            "write s: " + ", ".join(
                f"{k} {r['decode_s_per_mp']:.4f} ({r['decode_vs_baseline_jpeg']:.2f}x), "
                f"{r['plain_vs_cpp']:.1f}, {r['bytes_mean']:.0f} "
                f"({r['bytes_vs_baseline_jpeg']:.2f}x"
                + (f"; {r['bytes_vs_deflate']:.3f}x Deflate" if "bytes_vs_deflate" in r else "")
                + f"), {r['write_s']:.3f}" for k, r in r9["rows"].items()))
    log(f"[done] reader training {readers['phase_s']:.1f} s on {cpu}: views by phase "
        f"{readers['train_views_by_phase']} ({readers['train_lossless_views']} decode to "
        f"phase 9's bytes; {readers['train_views_by_new_form']}), "
        f"train_mesh load {readers['load_s']:.2f} s, {readers['steps']} steps in "
        f"{readers['train_s']:.2f} s (median {readers['step_ms_median']:.3f} ms)")
    log(f"[done] serve-and-shard phase (10a-10g) {t_serve:.1f} s on {smi} ("
        f"{SHARD_WORLD[0]}x{SHARD_WORLD[1]} ranks over {shard['backend']} on cards "
        f"{shard['cards']}): native ACAP {acap['host_ms']:.1f} ms per call on the host "
        f"({acap['threads']} threads) beside the card's deformation "
        f"{acap['card_deform_ms']:.2f} ms; viewer request ms median "
        f"{viewer['request_ms_median']:.1f} (render {viewer['render_ms_median']:.1f}, "
        f"encode {viewer['encode_ms_median']:.1f} on the host); end-to-end script "
        f"{e2e['seconds']:.1f} s (by step {({k: round(v, 1) for k, v in e2e['step_s'].items()})}); "
        f"4 bands max-abs {bands['max_abs']:.3g}; sharded step "
        f"ms median by rank {[round(x, 1) for x in shard['step_ms_median']]}, the 10e-10g "
        f"ranks' wall {shard['wall_s']:.1f} s; gloo on CUDA tensors: {shard['gloo_cuda']}")
    log(f"[done] Gaussian-table shard phase (the parent's part; its ranks run in 10e-10g's "
        f"processes) {gshard['phase_s']:.1f} s on {smi} ("
        f"{GSHARD_WORLD} ranks over {gshard['backend']} on cards {gshard['cards']}): "
        f"step ms median by "
        f"rank {[round(x, 1) for x in gshard['step_ms_median']]}; sent "
        f"{gshard['traffic']['bytes_sent_per_rank_step'] / 1e6:.1f} MB per rank and step "
        f"({gshard['traffic']['slots_per_rank']} slots); received live pairs by rank "
        f"{gshard['received_live']}; exchange ms per rank-step "
        f"{[round(x, 1) for x in gshard['exchange_ms']]}; emulated rank of 4 (forward "
        f"+ backward, one process) {gshard['emulated']['ms_median']:.2f} ms")
    log(f"[done] quality phase {quality['phase_s']:.1f} s on {smi}: SMALL test PSNR "
        f"by seed {[round(x, 4) for x in quality['final_psnr']]} (spread "
        f"{quality['spread_db']:.4f} dB) against the JAX package's "
        f"{quality['reference_psnr']:.4f}; SMALL it/s by seed "
        f"{[r['iters_per_second'] for r in quality['runs']]}; quality step checks "
        f"{quality['quality_step_s']:.1f} s")
    log(f"[done] tools phase {tools['phase_s']:.1f} s on {smi}: bench step "
        f"{tools['bench_step_ms']:.3f} ms ({tools['bench_mpix_s']:.2f} Mpix/s), the "
        f"prefix table's B7 {tools['prefix_b7_host_ms']:.3f} ms; playback fps config 3 "
        f"{tools['config3_fps']:.1f}, config 5 {tools['config5_fps']:.1f}; config-4 step "
        f"{tools['config4_step_ms']:.3f} ms; kernel checks {tools['kernel_check_s']:.1f} s")
    log(f"[done] scaling phase {scaling['phase_s']:.1f} s on {smi}: plain step "
        f"{scaling['plain_step_ms']:.3f} ms (busy {scaling['plain_busy_ms']:.3f}); "
        f"critical band by D {scaling['critical_band_ms']} ms (busy "
        f"{scaling['critical_band_busy_ms']}); critical emulated rank by D "
        f"{scaling['gshard_critical_ms']} ms (busy {scaling['gshard_critical_busy_ms']}); "
        f"modelled efficiency at D = {max(SCALING_D)} {scaling['efficiency']:.4f} (host "
        f"clock, NVLink 4 assumed); (1, 1) overheads: tile "
        f"{scaling['tile_1x1_overhead']:.3f}, gauss {scaling['gauss_1x1_overhead']:.3f}, "
        f"training step {scaling['train_ratio_host']:.3f}; kernel checks "
        f"{scaling['kernel_check_s']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
