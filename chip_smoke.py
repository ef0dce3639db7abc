#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (onebit_asr_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--profile]

Drives packed-ternary offline transcription of Conformer-M at full width and
depth (d=256, 12 blocks, 4 heads, d_ff 1024, vocab 5004, bf16) with random
weights drawn from --seed, on 8 synthetic waveforms of 2-16 s, then the
3-branch QAT train step of the same model, its data-parallel and ZeRO-2
forms over nccl, its tensor-parallel and pipelined forms on two ranks of
the card over gloo, and the train CLI (under torchrun too), then serves and
evaluates the runs the train CLI wrote, then trains, evaluates and serves on
a seeded data dir through the real-data path, then under the model options
(a streaming encoder, a quantized reference decoder, per-channel alpha),
then streams the streaming run through sessions, a server and the serve
daemon, evaluates a reference-layout checkpoint, and exports serving
artifacts and runs them from module.pt2 alone:

1. build: compiles csrc/*.cu with nvcc (sm_90a; one nvcc per source, all
   started together, then one link) and prints the time and each kernel's
   registers;
2. kernels: for each distinct (M, K, N) of one forward at B=8, 16 s
   (T'=512: M=4096, and 1023 for the position projection) each packed
   CUDA kernel is held against its plain PyTorch version on the card (bf16
   kernel: |d| <= 1e-4 + 1e-5*|ref|, f32 sums in another order; W2A8, which
   quantizes x per row inside its one launch: bit-exact) and timed with CUDA
   events beside its bound and torch.matmul on the dense unpacked bf16
   weight (`library_ms`, a yardstick only), with the CTAs its launch takes;
   their device time comes at the end (step 9); the
   fused subsampler kernel is held against its plain version at the path's
   shape (B=8, T=1598, F=80, C=256; within one bf16 ulp: rtol 2^-7, atol
   1e-3, conv2's f32 sums in another order) and timed beside the port's
   unfused cuDNN conv pair (`library_ms`, a yardstick only: it rounds conv1
   otherwise); its device time comes at the end (step 10); the fused rel-pos
   attention kernel is held against its plain
   version at the path's shape (B=8, H=4, T=512, dh=64, key lengths up to
   T'=398), at the Conformer-S head width dh=36 and with dropout rate 0.1
   from seeded draws (|d| <= 1e-2 + 2^-7*|ref|: one bf16 ulp of a
   probability or an output, f32 sums in another order) and timed beside
   the port's unfused attention chain (`library_ms`, a yardstick only: it
   rounds the scores to bf16; no single PyTorch call has the skewed
   position term);
3. path: the transcribe CLI (--packed) runs end to end on the bf16 kernel, with
   --int8_act, with a config that sets fused_subsampler, and with one that
   sets fused_attention and fused_subsampler; each run must launch its
   packed kernel 108 times per batch (9 packed projections x 12 blocks), the
   other never, the fused subsampler kernel exactly once per batch in the
   fused runs, the fused attention kernel 12 times per batch (once per
   block) in the fused-attention run, and neither otherwise. The
   fused-attention config is also served with --no_fused_kernels (no fused
   launch). Then the same models' CTC log-probs through the kernels are
   compared on valid frames with the models run on the plain versions on
   the card, and the greedy ids, ms per batch, peak memory and kernel
   launches per batch are printed; the unfused bf16 path is also run with
   PyTorch's default TF32 for cuDNN and compared with TF32 off;
4. attention backward: the fused rel-pos attention backward kernel is held
   against its plain version at the train step's shape (B=16, H=4,
   T'=256, dh=64, key lengths 128-255) with dropout 0.1 and 0, on a ragged
   case with an all-pad row (T=255) and at dh=36 (T=200): all six
   gradients within one bf16 ulp of the element plus one of the tensor's
   largest (f32 sums in another order; a ds element may round the other
   way), and two launches must give the same bits (fixed-order sums), as
   must the backward on the row statistics that row 3's training form
   wrote. That form's output (the train step's forward) must equal the
   serving form's bits and be held as step 2 holds it, and its row max and
   sum within 1e-4 of the plain ones (|d| <= 1e-4 (1 + |m|), 1e-4 l; the
   same products summed in another f32 order). It is timed on those statistics (the main path) beside its bound
   and the unfused attention chain's `.backward()` through autograd
   (`library_ms`, a yardstick only), and row 3's training form is timed at
   the same shape;
5. subsampler backward: the fused subsampler backward kernel (row 6) is
   held against its plain version at the train step's shape (B=16,
   T=1024, F=80, C=256), on a ragged T (T2=25) and at C=144: its masked
   cotangent must equal the plain version's except where y_pre is within
   f32 rounding of 0, and its five gradients must match the plain backward
   applied to that cotangent (dx, dw1, db1 within one bf16 ulp of the
   element plus one of the tensor's largest: a dpat element may round the
   other way; dw2, db2 within 1e-4 of it); two launches must give the same
   bits. It is timed beside its bound and the unfused cuDNN conv pair's
   backward through autograd (`library_ms`, a yardstick only), and row 5's
   forward is timed at the same shape; their device time comes at the end
   (step 10);
6. ctc: the CTC alpha and beta lattice kernels are held against their plain
   versions at the train step's shape (the three branches of B=16 in one
   launch: B=48, T'=256, S=97), at LibriSpeech's ceiling (T=512, B=16,
   S=457) and on a ragged case (lengths < T, label length 0, an infeasible
   row, repeated labels): equal bit for bit, and, as a second check, NEG_INF
   entries matching as a pattern and finite ones within 1e-5 relative;
   timed at the step's shape beside F.ctc_loss forward (alpha) and forward
   + backward (beta), whose NLL also cross-checks the port's; the bound
   counts the emission rows these lengths need;
7. train: the library train step (train/step.py::make_train_step) at full
   Conformer-M width and depth, dropout 0.1, on bench.py's batch of record
   (B=16, 1,024 frames, U=48): a warm-up step, then TRAIN_STEPS steps that
   must launch each lattice kernel exactly once per step and give finite
   losses and gradient norms; ms per step and peak memory (above what
   earlier phases still hold) are printed, and
   one step on the kernels is held against the same step with the plain
   lattices (aux rtol 1e-4, gradients within 1e-2 of their norm: the
   backward's atomic sums run in no fixed order). Then the same with
   fused_attention=True: 36 forward and 36 backward attention launches and
   1 + 1 lattice launches per step, and one step on the kernels held
   against the same step with `attention_fn` set to the plain Function
   (aux rtol 1e-2, gradients within 0.1 of their norm: bf16 layers carry a
   probability or gradient element rounded the other way through 12
   blocks) and, loosely, against the unfused chain's step on the same
   draws (gradient cosine >= 0.95: the chain rounds the scores to bf16).
   Then the same with fused_subsampler=True: 3 forward and 3 backward
   subsampler launches and 1 + 1 lattice launches per step, and one step
   on the kernels held against the same step with `subsample_fn` set to
   the plain Function (aux rtol 1e-2, gradients within 0.1 of their norm)
   and, loosely, against the unfused conv pair on the same draws (gradient
   cosine >= 0.95: the pair rounds the features and conv1 to bf16);
8. train cli: `python -m onebit_asr_tpu_torch.train --dummy_data` for 2
   epochs of 3 steps at Conformer-M widths, then a --resume run of a third
   epoch in this process, which must continue from step 6; then one epoch
   with --fused_attention and one with --fused_subsampler
   --fused_attention in this process, with their launches counted;
9. device time of the packed kernels: at each step-2 shape, 20 calls of
   each wrapper and of torch.matmul under torch.profiler give the device
   time per call (`device_ms`, `library_device_ms`; the events' host-side
   `ms` reads launch overhead once a kernel takes a few us); each wrapper
   call must be exactly one device kernel (W2A8's quantization included).
   Run after every timed phase: a finished profiler run slows later host
   code;
10. device time of the subsampler kernels: row 5 at the serving shape and
   at the train step's (B=16, T=1,024), row 6 at the train step's, per pass
   (mask, conv1, dw2, reduce), each beside the unfused cuDNN conv pair's
   device time (forward; backward through autograd) and its bound
   (`device_ms`, `library_device_ms`, `bound_share`), with the CTAs and
   grid of each launch and row 6's workspace in MB;
11. device time of the attention kernels: row 3 at the serving shape and,
   in its training form (which also writes each row's max and sum), at the
   train step's (B=16, T'=256, dropout 0.1); row 4 at the train step's on
   those statistics, per kernel (rowdot, gradients, reduce), and alone;
   each beside the unfused attention chain's device time (forward;
   backward through autograd), a second yardstick that is not the same
   function (F.scaled_dot_product_attention on the same q, k, v and key
   mask: the content term only) and its bound (`device_ms` per serving
   forward for row 3 and per launch for row 4, `train_device_ms` for the
   row's 36 launches of a train step, `library_device_ms`,
   `sdpa_device_ms`, `bound_share`), with the CTAs, grid and shared bytes
   of each launch and row 4's workspace in MB; each wrapper call must run
   exactly its own kernels, in a complete profile, and its profiler time
   must lie within [0.7, 1.1] x the CUDA events' time of the same calls
   queued back to back behind a spin of the card (the host's dispatch
   hidden);
12. device time of the CTC lattice kernels: rows 7 and 8 at the train
   step's shape (B=48, T=256, S=97) and at LibriSpeech's ceiling (B=16,
   T=512, S=457), each wrapper call exactly one device kernel on the loss's
   operands (int64 lengths, a bool mask), its profiler time within [0.7,
   1.1] x the queued CUDA events' as in step 11, beside its bound, the
   time per step of the recursion (ms / (T-1)), the kernel variant (states
   a lane, warps an utterance) and, as `library_device_ms`, the device time
   of F.ctc_loss's own lattice kernel on the same lattice (its log-alpha
   kernel in the forward, its log-beta kernel in the backward, picked by
   name from the same profile; the port never calls it);
13. serve the trained runs (run right after step 8, before the device
   steps 9-12: it times host-bound loops, which a finished profiler run
   slows): the runs step 8 wrote (Conformer-M at full width, the synthetic
   backend's vocabulary of 32; "smoke" unfused, "smoke_fs_fa" with both
   fused flags) are restored from their checkpoints and served on step 3's
   8 waveforms through `transcribe --checkpoint` (with a character-level
   tokenizer over their vocabulary: a run without one exits 2): packed at
   precision 2 and 1, with --int8_act and under the fused flags, each
   launching its packed kernel 108 times a batch (and the fused kernels once
   and 12 times), the ids it decodes (`decoded_ids`) equal to
   `Transcriber`'s on `jax_tree_from_state_dict` of the restored
   parameters, and its text to theirs decoded by the tokenizer; unpacked
   (the QAT model) at precision 32, 2 and 1 under the fused flags, the
   same, and its CTC log-probs held against the same model on
   the plain versions at step 3's tolerances (mean |d| <= 0.05, argmax
   agreement >= 0.9); with --beam_size 10, with and without a 3-gram LM.
   The device beam is held against the native host beam on the same f32
   log-probs, beam 10, with and without a 3-gram LM fitted on seeded id
   sequences, for the trained run and for step 3's random Conformer-M with
   its vocabulary of 5,004 (`beam_agreement` states how a tie is told from
   a bug); greedy, beam 10 and beam 10 + LM are timed per batch (B=8,
   T'=398 padded to 512) with CUDA events. One 75 s waveform is served
   --longform in 30 s windows overlapping by 4 s (3 windows), its stitched
   log-probs held against the plain path at step 3's tolerances. `python -m
   onebit_asr_tpu_torch.eval --checkpoint --dummy_data` runs greedy, with
   the beam and --packed, printing loss, WER and CER per precision, with
   the CTC alpha kernel once per batch and precision. The device kernels
   and copies of one batch of each decode mode are counted with
   torch.profiler at the end;
14. real data (run after step 13, before the device steps 9-12: it times
   steps): a seeded data dir written with the port's own `write_manifest`
   (train 48, dev 8, test 8 synthetic waveforms of 2-10 s in npz shards, a
   character-level tokenizer.model, CMVN statistics by the port's frontend,
   token ids in every other manifest row) and a copy with a float16
   feature cache. SpecAugment on the card must equal the CPU bit for bit on
   the same starts (f32 and f16). `python -m onebit_asr_tpu_torch.train
   --data_dir` (in process) trains Conformer-M under both fused flags with
   SpecAugment and prefetch depth 4, B=16 in 3 length buckets, 3 steps an
   epoch for 2 epochs: finite losses, `input_wait_frac` logged, rows 3-8
   launched as step 8 counts them, at least two bucket lengths T; ms per
   step (CUDA events) by T beside step 7's, peak memory. At each of the
   run's bucket lengths T (first training batch of each bucket), one step's
   loss and gradients on the kernels are held against the same step with
   the plain attention, the plain subsampler and the plain lattices in turn
   (step 7's tolerances), and the forward alone against all plain versions
   (aux within 1e-2). A second run of 2 steps on the feature cache must
   never call the frontend. `eval --data_dir --splits dev,test` launches
   row 7 once per batch and precision; `transcribe --split test --packed`
   (precision 2, and with --int8_act) launches rows 1-2 108 times a batch,
   writes the manifest's utt_ids in the data module's order, and the ids it
   decodes equal `Transcriber`'s; with an empty --data_dir it exits 2.
   `--no_real_data` skips this step.
15. prepare and the step options (run after step 16, before the device
   steps 9-12): `python -m onebit_asr_tpu_torch.prepare` (in process)
   ingests `--synthetic 64 --hard` (64/8/8 utterances of up to 8 s), a
   character-level tokenizer.model over its words' characters is written
   (the card's machine has no `tokenizers`), then `tokenize`, `cmvn`,
   `features` and `lm` run; `cmvn` and `features` run on the card and again
   with `--device cpu` into a copy (the CPU's features on the card's
   statistics), and the two are held at the CPU tests' tolerances (CMVN
   within 1e-5 |x| + 1e-5 max |x|; manifests equal; features within 2e-4
   + 1e-4 |x| + one f16 ulp). The spectrogram CLI's array
   (`cli/spectrogram.py::log_mel`: the synthetic chirp, and the first dev
   utterance under the card's CMVN) is held card vs CPU at the CPU test's
   tolerance against JAX (the mel power within 1e-5 of each frame's peak,
   the log-mel within 2e-4 + 1e-4 |x| in the bins within 10 nats of it;
   CMVN undone); the CLI itself is not run (the card's machine has no
   matplotlib). `train --data_dir` then trains Conformer-M
   under both fused flags with `--grad_accum 2 --multistep 2` for 4
   optimizer steps at B=16 in 2 buckets: each micro-batch of 8 launches
   rows 3-8 as step 8 counts them, at least one call goes through the
   K-step form, losses are finite; ms per optimizer step (CUDA events) and
   peak memory are printed beside step 14's at B=16. One grad_accum=2 QAT
   step and one grad_accum=2 fp32-control step on the kernels are held
   against the same step with each kernel pair on its plain version in
   turn (step 7's tolerances). `train --fp32_control --profile_dir` runs
   one step: only 32-bit evaluation is logged, and its Chrome trace must
   name row 7's kernel.
16. model options (run after step 14, before step 15 and the device steps
   9-12: it times steps, and a finished profiler session slows host code):
   `python -m onebit_asr_tpu_torch.train --dummy_data` (in process) trains
   Conformer-M (vocabulary 32) for 2 steps at B=16, 1,024 frames (T'=256),
   with one evaluation batch at 32/2/1, three ways; each run's ms per step
   (CUDA events) and peak memory are printed beside step 7's. (a)
   `--conv_norm layer_norm --causal_conv --attn_chunk_size 16
   --attn_left_chunks 2` under both fused flags: rows 5-8 as step 8 counts
   them, rows 3-4 never (JAX takes its XLA attention whenever a pair mask
   is set, onebit_asr_tpu/model/conformer.py:310-316, and so does the
   port); then `transcribe --checkpoint --packed` at precision 2 and with
   `--int8_act` launches rows 1-2 108 times a batch, and the run's CTC
   log-probs through the kernels are held against the plain path at step
   3's tolerances. (b) `--quant_decoder --reference_decoder --conv_norm
   group_norm` under both fused flags: rows 3-8 as step 8 counts them; one
   step (the reference smoothing on) at bench.py's batch is held against the
   same step with each kernel pair on its plain version in turn (step 7's
   tolerances); the trained run packed with its decoder, at precision 2
   and with --int8_act, runs `forward_with_decoder` on that batch: rows
   1-2 launch 128 times (108 encoder + 20 decoder projections, the
   decoder's at M = B(U+1) = 784 rows), and its decoder and CTC log-probs
   are held against the plain path at step 3's tolerances; `evaluate
   --packed --precisions 2` launches row 1 128 times a forward, and its
   loss is held against the unpacked precision-2 loss within 2% + 0.002.
   (c)
   `--quant_per_channel`, unfused: evaluated at 32/2/1, served unpacked, and
   `transcribe --packed` must fail with the packed export's per-channel
   NotImplementedError, as JAX's export does.
17. streaming (right after step 16 (a), on its run, before step 15 and any
   profiler session): step 3's 8 waveforms are featurized one by one on the
   card (the daemon's `wav_featurizer`, step 3's CMVN). (i) One
   `StreamingSession` per utterance at precision 2, fed in pushes of 10
   frames (100 ms): its chunk log-probs on valid frames against the same
   run's offline chunked encoder with the fused flags cleared (step 3's
   tolerances; the share of utterances with equal ids is printed). (ii) One
   `StreamingServer(max_streams=8)` over all 8, against (i) the same way.
   (iii) `python -m onebit_asr_tpu_torch.serve --checkpoint` as a
   subprocess on stdio on the default device, driven with NDJSON (8 `open`,
   `feed_wav`, `close`): its finals must equal (ii)'s ids. (iv) `evaluate
   --streaming --dummy_data --max_batches 1` exits 0. No kernel row launches
   in (i)-(iii) (the daemon reports its own counts on exit). Printed: ms per
   chunk step (CUDA events, full caches) at N=1 and N=8, the real-time
   factor per stream (a chunk of 16 frames is 640 ms of audio), peak memory,
   the step's wall time; device kernels per chunk step come at the end
   (torch.profiler).
18. a reference checkpoint (after step 17, before step 15): a Conformer-M
   reference-layout state dict (`reference_state_dict`, the inverse of
   utils/torch_import.py; vocabulary 5,004, 2 decoder layers) drawn from
   --seed is saved with `torch.save` beside a config.json; the import must
   give back the drawn tree bit for bit. `evaluate --torch_checkpoint
   --dummy_data --greedy --max_batches 1 --precisions 32,2,1` runs
   unpacked (row 7 once a precision), `--packed` (row 1 108 times a
   forward, row 2 never) and `--packed --int8_act` (the other way round).
   The packed f32 model on step 3's 8 waveforms on rows 1 and 2 is held
   against the plain path at step 3's tolerances; ms per batch (CUDA
   events) beside the unpacked f32 forward.
19. serving artifacts (export.py on torch.export; (a)-(d) after step 18,
   (e) at the end of step 13, (f) inside step 17, each on what that step
   built; none before a profiler session): every artifact is exported,
   saved (module.pt2, or a module_<device>.pt2 a member, + meta.json) and
   loaded back, and its export, save and load seconds and sizes are
   printed. (a) step 3's random
   Conformer-M with both fused flags, packed at precision 2, B=8, T=1,598
   (step 3's features): one forward from the loaded artifact launches row
   1 exactly 108 times, row 5 once, row 3 12 times and row 2 never, and its
   log-probs on valid frames are held against the live packed forward
   (mean |d| <= 1e-3, argmax agreement >= 0.99; the share bit-equal
   printed); (b) the same without the fused flags and with --int8_act (row
   2 108 times, nothing else); (c, d) both fused flags, unpacked at precision 2,
   one symbolic-batch artifact: at B=8 and at B=1 row 5 once and row 3 12
   times a forward, held the same way; (e) step 13's run through `cli.export
   offline --packed --emit beam --beam_size 10 --lm` (step 13's 3-gram LM
   baked in) at 35 raw frames (T'=8: the artifact unrolls the beam's frame
   loop, ~430 graph nodes a frame, and export, save and load grow with the
   nodes; PERF.md §6): its ids must equal the live device beam's; (f) step
   17's run through `cli.export streaming --n_streams 8`, served by `serve
   --artifact` as a subprocess on stdio with step 17's NDJSON: its finals
   must equal step 17 (ii)'s server ids for all 8 streams. ms per batch (or
   chunk step) from each artifact beside the live forward (CUDA events; in
   (a)-(d) the median of 6 alternating rounds of 3 calls each, with the
   rounds' range of artifact/live ratios). (a) is exported for platforms
   ("cuda", "cpu") into one artifact (module_cuda.pt2 and module_cpu.pt2):
   the checks above load its default member, cuda; its cpu member, loaded
   by device and run on the same features on the host, must launch nothing,
   give the same valid frames and stay within step 3's tolerances of the
   cuda member's log-probs (mean |d| <= 0.05, argmax agreement >= 0.9).

20. data parallel (run after step 7, before step 8): Conformer-M with both
   fused flags at dropout 0, B=16, 1,024 frames, U <= 48, over an nccl
   process group of world 1 made in this process (MASTER_ADDR=127.0.0.1, a
   free port): 1 + 3 steps each of the one-process step, the data-parallel
   step (`make_sharded_train_step`) and the ZeRO-2 step
   (`make_fsdp_train_step`, its state sharded and gathered back), each from
   a fresh copy of the same state, and the one-process step once more (its
   run-to-run spread on the card), AdamW at a one-step warm-up (the LR is
   0 at step 0 and 5e-4 after). Each parallel step's launches of rows 3-8
   must equal the one-process step's, and its distance to the one-process
   step stay within DP_TOL, set from that spread (scripts/dp_probe.py):
   loss and aux terms relative 5e-3, grad_norm relative 3e-2, parameters
   |p - p_ref| / |p_ref - p_0| <= 0.1 (1 for a step that does not move
   them), moments |d| / |ref| <= 3e-2 over all leaves; over one rank it is
   bit-equal when the card repeats the step bit for bit, which the
   one-process step itself does not always do (PERF.md §6). Each distance,
   max |d| of loss, grad_norm, parameters and moments, whether they are
   bit-equal, ms per step (CUDA events over the 3 steps) and peak memory
   are printed. Then
   `python -m torch.distributed.run --standalone --nproc_per_node 1 -m
   onebit_asr_tpu_torch.train --fsdp --dummy_data` at a small width for 2
   epochs, and its `--resume` to a third; both must exit 0.
21. tensor parallel (right after step 20): rows 3 and 4 at a TP rank's
   local shape (B=16, H=2 of 4, T'=256, dh=64, dropout 0.1), each head half
   held against their plain versions (step 4's tolerances) and against
   the same heads' slice of one launch on all 4 heads (max |d| and whether
   it is bit-equal printed); then two processes on the one card join a
   gloo group (gloo sums CUDA tensors through the host; nccl takes one
   rank a device) as a (data 1, model 2) mesh and run
   `make_tp_train_step` on step 20's model and batch (Conformer-M, both
   fused flags: 2 heads and d_ff 512 a rank): 1 + 3 steps at dropout 0
   against step 20's one-process run within TP_TOL (DP_TOL, but loss and
   aux 1.5e-2: the row-parallel sums round the bf16 activations apart,
   and the updates grow it), and one step at dropout 0.1 from a fresh
   state against the one-process step at 0.1 (the LR is 0 at step 0: loss,
   aux, grad_norm and moments) within DP_TOL. Each rank must launch
   rows 3-8 as often as the one-process step (36/36/3/3/1/1 a step), rows
   3-4 on 2 heads only, and gather the same full state (a hash); ms per
   step and peak memory per rank are printed beside the one-process
   step's.
22. pipeline parallel (right after step 21): rows 3 and 4 at a microbatch's
   shape (B=8 of 16, H=4, T'=256, dh=64, dropout 0.1), each half of the
   rows held against their plain versions (step 4's tolerances) and against
   the same rows of one launch on all 16 (out, dq, dk, dv; dp, du, dvb as
   the halves' sum; max |d| and whether it is bit-equal printed); then two
   processes on the one card join a gloo group as a (data 1, stage 2) mesh
   and run `make_pipeline_train_step` with M=2 microbatches on step 20's
   model with the per-frame layer norm in the conv module (the pipeline
   refuses batch norm) and batch: 1 + 3 steps at dropout 0 against the
   one-process step on that model within PP_TOL, and one step at dropout
   0.1 from a fresh state against the one-process step at 0.1 (loss, aux,
   grad_norm and moments). Each rank must launch rows 3-4 3 x M x L/S = 36
   times a step on 8 rows, rows 5-6 3 times on stage 0 and never on stage
   1, rows 7-8 once, and gather the same full state (a hash); ms per step
   and peak memory per rank are printed beside the one-process step's,
   with the bubble fraction (S-1)/(M+S-1).

`device_ms` opens each profile with 64 short spins of the card: after a
process's first profiler session, each later session drops its first few
kernel records, more the longer ago that session was (ROADMAP C3), and the
spins take the loss. It retakes a profile that kept none of its spins (with
4x as many) or lost launches, up to 5 profiles, and the script prints how
many profiles each call took and how many spins they lost.

Prints a {"kernels": [...]} line, the card's name and power limit, and last
{"ok": true, "device": {...}}. Exits non-zero without that line when there
is no CUDA card or any phase fails. Imports nothing of JAX or onebit_asr_tpu.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import wave

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
BATCH = 8
SAMPLE_RATE = 16000
TRAIN_STEPS = 3
REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"  # where the training phases run
STEP_MS = {}  # step 7's ms per step by label, printed beside step 14's
REAL_TRAIN = {}  # step 14's ms per step by T and peak memory, printed beside step 15's
PROFILES = []  # profiles device_ms took per call (tries + 1: none complete)
PAD_LOST = []  # opening spins each of device_ms's profiles lost (ROADMAP C3)


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def _reset(kernels):
    """Every kernel wrapper's launch count to 0."""
    for fn in kernels.values():
        fn.launches = 0


def _counts(kernels):
    """{name: launches} of the wrappers that launched since `_reset`."""
    return {k: fn.launches for k, fn in kernels.items() if fn.launches}


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call on the card (CUDA events around `iters` calls)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_breakdown(fn, top: int = 15) -> None:
    """Device time of one call of `fn` by kernel name (torch.profiler), and
    the share of the call's wall time in which the card ran no kernel. The
    card's busy time is printed with and without the host-to-device copies,
    whose time depends on the host (a pageable copy waits for it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        log("profile: the profiler recorded no device events")
        return
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3

    def busy_ms(events):
        busy, end = 0.0, float("-inf")
        for s, e in sorted((k.time_range.start, k.time_range.end) for k in events):
            busy += max(0.0, e - max(s, end))
            end = max(end, e)
        return busy / 1e3

    busy = busy_ms(kernels)
    no_htod = busy_ms([k for k in kernels if "HtoD" not in k.name])
    total = sum(by_name.values())
    log(f"profile: wall_ms={wall_ms:.2f} kernel_ms={total:.2f} busy_ms={busy:.2f} "
        f"busy_ms_without_htod={no_htod:.2f} idle_share={1 - busy / wall_ms:.3f} "
        f"kernels={len(kernels)}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        log(f"profile: {ms:8.3f} ms {ms / total:6.1%}  {name[:90]}")


def path_shapes(cfg, t_pad: int):
    """(M, K, N) -> launches per forward of every packed projection."""
    d, dff, L = cfg.enc_d_model, cfg.enc_d_ff, cfg.enc_layers
    M = BATCH * t_pad
    return {
        (M, d, dff): 2 * L,          # ff1.w1, ff2.w1
        (M, dff, d): 2 * L,          # ff1.w2, ff2.w2
        (M, d, d): 4 * L,            # q, k, v, out projections
        (2 * t_pad - 1, d, d): L,    # position projection
    }


def kernel_phase(cfg, t_pad, seed):
    from onebit_asr_tpu_torch.ops import ternary_matmul as tm

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    rows = {}
    for name, kind, kernel, plain in (
        ("ternary_matmul_bf16", "bf16", tm.ternary_matmul, tm.ternary_matmul_reference),
        ("ternary_matmul_w2a8", "int8", tm.ternary_matmul_w2a8, tm.ternary_matmul_w2a8_reference),
    ):
        tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
        max_err, bytes_bound, ctas = 0.0, True, {}
        for (M, K, N), n in path_shapes(cfg, t_pad).items():
            x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(dev)
            x = x.to(torch.bfloat16)
            q = torch.from_numpy(rng.integers(-1, 2, size=(K, N)).astype(np.float32))
            packed = tm.pack_planar(q).to(dev)
            alpha = torch.tensor(rng.uniform(0.01, 0.1), dtype=torch.float32, device=dev)
            out = kernel(x, packed, alpha)
            ref = plain(x, packed, alpha)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            max_err = max(max_err, err)
            if kind == "int8":
                if not torch.equal(out, ref):
                    raise AssertionError(f"{name} {M}x{K}x{N}: not bit-exact (max |d| {err})")
            elif not bool(((out - ref).abs() <= 1e-4 + 1e-5 * ref.abs()).all()):
                raise AssertionError(f"{name} {M}x{K}x{N}: max |d| {err} over tolerance")
            w = tm.unpack_planar(packed).to(torch.bfloat16)
            plan = tm.launch_plan(kind == "int8", M, K, N)
            ms = cuda_ms(lambda: kernel(x, packed, alpha))
            plain_ms = cuda_ms(lambda: plain(x, packed, alpha))
            lib_ms = cuda_ms(lambda: torch.matmul(x, w))
            nbytes = M * K * 2 + K * N // 4 + M * N * 4 + 4
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = 2.0 * M * N * K / PEAK_OPS[kind] * 1e3
            bytes_bound &= t_bytes >= t_ops
            for key, v in (("ms", ms), ("plain_ms", plain_ms),
                           ("bound_ms", max(t_bytes, t_ops)), ("library_ms", lib_ms)):
                tot[key] += n * v
            ctas[f"{M}x{K}x{N}"] = plan["ctas"]
            log(f"kernel {name} M={M} K={K} N={N} x{n}/forward: max|d|={err:.3g} "
                f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={max(t_bytes, t_ops):.4f} "
                f"library_ms={lib_ms:.4f} ctas={plan['ctas']} (rows/CTA {plan['bm']}, "
                f"{plan['nsplit']} along N)")
        rows[name] = {
            "name": name,
            "route": "cuda",
            "source": "onebit_asr_tpu_torch/csrc/ternary_matmul.cu",
            "replaces": ("onebit_asr_tpu/ops/ternary_matmul.py:60" if kind == "bf16"
                         else "onebit_asr_tpu/ops/ternary_matmul.py:190"),
            "launches": 0,
            "max_abs_err": max_err,
            **tot,
            "bound_by": "bytes" if bytes_bound else "operations",
            "ctas": ctas,
        }
    return rows


SPIN_KERNEL = "spin_kernel"  # the kernel torch.cuda._sleep launches


def opening_spins(n):
    """`n` short spins of the card (~0.5 us each) for a profile to open
    with: after a process's first profiler session, later sessions drop
    their first few kernel records (ROADMAP C3), and the spins take the
    loss."""
    for _ in range(n):
        torch.cuda._sleep(1 << 10)


def device_ms(fn, iters: int = 20, tries: int = 5, per_kernel: bool = False):
    """(device ms per call, kernel names) of `fn` under torch.profiler: each
    kernel's mean duration times its launches per call, without launch gaps.
    The calls queue behind `pad` short spins of the card (torch.cuda._sleep):
    once a process has run a profiler session, each later session drops the
    first few kernel records it would keep, more the longer ago that first
    session was (ROADMAP C3), and the spins take the loss. A profile that
    kept none of its spins is taken again behind 4x as many; one in which a
    kernel ran on fewer calls than were made is taken again too; it raises
    after `tries`. With per_kernel, the names are a dict: kernel name -> ms
    per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    counts, pad, spins = {}, 64, 0
    for n in range(1, tries + 1):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            opening_spins(pad)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by_name, spins = {}, 0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                if SPIN_KERNEL in e.name:
                    spins += 1
                else:
                    by_name.setdefault(e.name, []).append(e.time_range.elapsed_us() / 1e3)
        counts = {k[:60]: len(v) for k, v in by_name.items()}
        PAD_LOST.append(pad - spins)
        if spins and by_name and all(len(v) % iters == 0 for v in by_name.values()):
            # each kernel's mean duration times its launches per call (a call
            # of a library op may launch one kernel several times)
            per = {k: sum(v) / len(v) * (len(v) // iters) for k, v in by_name.items()}
            PROFILES.append(n)
            return sum(per.values()), per if per_kernel else sorted(by_name)
        log(f"device_ms: profile {n} of {tries} lost launches ({spins} of its {pad} opening "
            f"spins kept; events per kernel: {counts}); taking it again")
        if not spins:
            pad *= 4
    PROFILES.append(tries + 1)
    raise AssertionError(
        f"the profiler recorded no complete profile of {iters} calls in {tries} tries (events "
        f"per kernel in the last: {counts}; {spins} of its {pad} opening spins kept"
        + ("" if spins else ": the profiler dropped the window's first records, ROADMAP C3")
        + ")")


def queued_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call on the card with the host's dispatch hidden: CUDA
    events around `iters` calls queued behind a spin of the card
    (torch.cuda._sleep) that outlasts their dispatch, so the card runs them
    back to back. The spin doubles until the start event is still pending
    when the last call is queued."""
    for _ in range(warmup):
        fn()
    cycles = 1 << 24  # ~10 ms at the H100's clock
    for _ in range(6):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) / iters
        cycles *= 4
    raise AssertionError("the host did not queue the calls ahead of the card")


def kernel_device_phase(cfg, t_pad, seed, rows):
    """Device time per call of the packed kernels and of torch.matmul on the
    dense bf16 weight at the path's shapes, per forward in the rows."""
    from onebit_asr_tpu_torch.ops import ternary_matmul as tm

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 1)
    for name, kernel, kname in (
        ("ternary_matmul_bf16", tm.ternary_matmul, "ternary_bf16_kernel"),
        ("ternary_matmul_w2a8", tm.ternary_matmul_w2a8, "ternary_w2a8_kernel"),
    ):
        dev_tot, lib_tot = 0.0, 0.0
        for (M, K, N), n in path_shapes(cfg, t_pad).items():
            x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(dev)
            x = x.to(torch.bfloat16)
            q = torch.from_numpy(rng.integers(-1, 2, size=(K, N)).astype(np.float32))
            packed = tm.pack_planar(q).to(dev)
            alpha = torch.tensor(rng.uniform(0.01, 0.1), dtype=torch.float32, device=dev)
            w = tm.unpack_planar(packed).to(torch.bfloat16)
            ms, names = device_ms(lambda: kernel(x, packed, alpha))
            if len(names) != 1 or kname not in names[0]:
                raise AssertionError(f"{name} {M}x{K}x{N}: device kernels {names}, want one "
                                     f"{kname}")
            lib_ms, lib_names = device_ms(lambda: torch.matmul(x, w))
            t_bytes = (M * K * 2 + K * N // 4 + M * N * 4 + 4) / HBM_BYTES_PER_S * 1e3
            t_ops = 2.0 * M * N * K / PEAK_OPS["int8" if "w2a8" in name else "bf16"] * 1e3
            dev_tot += n * ms
            lib_tot += n * lib_ms
            log(f"kernel device {name} M={M} K={K} N={N} x{n}/forward: device_ms={ms:.5f} "
                f"kernels/call=1 library_device_ms={lib_ms:.5f} (torch.matmul: "
                f"{', '.join(n[:40] for n in lib_names)}) bound_ms={max(t_bytes, t_ops):.5f} "
                f"bound_share={max(t_bytes, t_ops) / ms:.3f}")
        row = rows[name]
        row.update(device_ms=dev_tot, library_device_ms=lib_tot,
                   bound_share=row["bound_ms"] / dev_tot)
        log(f"kernel device {name} per forward: device_ms={dev_tot:.4f} "
            f"library_device_ms={lib_tot:.4f} bound_ms={row['bound_ms']:.4f} "
            f"bound_share={row['bound_share']:.3f}")


def _subsample_case(rng, B, T, Fd, C, dev):
    """Random subsampler operands at one shape: x, w1, b1, w2 (f32), b2 and
    a bf16 cotangent with a fifth of its elements 0."""
    from onebit_asr_tpu_torch.ops.subsampler import out_len

    gn = rng.standard_normal((B, out_len(out_len(T)), out_len(out_len(Fd)), C))
    gn[rng.random(gn.shape) < 0.2] = 0.0  # as the masked time steps give
    x, w1, b1, w2, b2, g = (torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
        rng.standard_normal((B, T, Fd)),
        rng.standard_normal((3, 3, C)) / 3.0,
        rng.uniform(-1 / 3, 1 / 3, C),
        rng.standard_normal((9 * C, C)) / np.sqrt(9 * C),
        rng.uniform(-1, 1, C) / np.sqrt(9 * C),
        gn,
    ))
    return (x, w1, b1, w2, b2), g.to(torch.bfloat16)


def subsample_device_phase(cfg, frames, seed, rows):
    """Device time per launch (torch.profiler) of rows 5 and 6 and of the
    port's unfused cuDNN conv pair (forward; backward through autograd): row
    5 at the serving shape (B=8, `frames`) and the train step's (B=16,
    T=1,024), row 6 at the train step's, per pass. Adds device_ms,
    library_device_ms, bound_share (bound_ms / device_ms), the CTAs and
    grids of the launch plan, row 6's per-pass device ms and workspace MB to
    the kernels' rows. Run after every timed phase, as kernel_device_phase."""
    from onebit_asr_tpu_torch.ops import subsampler as ss

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed + 2)
    Fd, C = cfg.input_dim, cfg.enc_d_model
    passes = (("mask", "conv2_kernel<true>"), ("conv1", "bwd_conv1_kernel"),
              ("dw2", "bwd_dw2_kernel"), ("reduce", "bwd_reduce"))
    row5, row6 = rows["fused_subsample"], rows["fused_subsample_bwd"]
    for label, B, T in (("serving", BATCH, frames), ("train step", 16, 1024)):
        (x, w1, b1, w2, b2), g = _subsample_case(rng, B, T, Fd, C, dev)
        w2b = w2.to(torch.bfloat16)
        plan = ss.launch_plan(B, T, Fd, C)
        with torch.no_grad():
            ms, names = device_ms(lambda: ss.fused_subsample(x, w1, b1, w2b, b2), per_kernel=True)
            lib_ms, _ = device_ms(lambda: unfused_subsample(x, w1, b1, w2b, b2))
        if len(names) != 1 or "conv2_kernel<false>" not in next(iter(names)):
            raise AssertionError(f"fused_subsample {label}: device kernels {sorted(names)}, want "
                                 f"one fused_subsample_conv2_kernel<false>")
        grid = [plan["fwd_grid_x"], plan["fwd_grid_y"], plan["fwd_grid_z"]]
        ctas = grid[0] * grid[1] * grid[2]
        T2, F2 = ss.out_len(ss.out_len(T)), ss.out_len(ss.out_len(Fd))
        T1, F1 = ss.out_len(T), ss.out_len(Fd)
        t_bytes = (x.numel() * 4 + B * T2 * F2 * C * 2 + w2.numel() * 2 + 11 * C * 4) \
            / HBM_BYTES_PER_S * 1e3
        t_conv2 = 2.0 * B * T2 * F2 * C * 9 * C / PEAK_OPS["bf16"] * 1e3
        t_conv1 = 2.0 * B * T1 * F1 * C * 9 / PEAK_OPS["f32"] * 1e3
        bound = max(t_bytes, t_conv2, t_conv1)
        log(f"kernel device fused_subsample {label} B={B} T={T}: device_ms={ms:.5f} "
            f"library_device_ms={lib_ms:.5f} (unfused cuDNN convs) bound_ms={bound:.5f} "
            f"bound_share={bound / ms:.3f} ctas={ctas} grid={grid} rows/CTA={plan['fwd_r2']}")
        if label == "serving":
            row5.update(device_ms=ms, library_device_ms=lib_ms, bound_share=row5["bound_ms"] / ms,
                        ctas=ctas, grid=grid)
            continue
        row5.update(train_device_ms=ms, train_library_device_ms=lib_ms,
                    train_bound_share=bound / ms, train_ctas=ctas, train_grid=grid)
        ops = (x, w1, b1, w2, b2)
        # the launch's four kernels (the call also casts the f32 w2 to bf16)
        _, per = device_ms(lambda: ss.fused_subsample_bwd(*ops, g), iters=10, per_kernel=True)
        by_pass = {name: sum(v for k, v in per.items() if key in k) for name, key in passes}
        ms6 = sum(by_pass.values())
        if not all(by_pass.values()):
            raise AssertionError(f"fused_subsample_bwd: device kernels {sorted(per)}, want the "
                                 f"four passes {[k for _, k in passes]}")
        leaves = [t.clone().requires_grad_(True) for t in ops]
        y = unfused_subsample(*leaves)
        lib6, _ = device_ms(lambda: torch.autograd.grad(y, leaves, g, retain_graph=True),
                            iters=10)
        del y, leaves
        grids = {"mask": grid, "conv1": [plan["conv1_ctas"] // B, B, 1],
                 "dw2": [C // 16, -(-C // 256), plan["dw2_splits"]]}
        ctas6 = {"mask": ctas, "conv1": plan["conv1_ctas"], "dw2": plan["dw2_ctas"]}
        ws_mb = plan["workspace_floats"] * 4 / 1e6
        row6.update(device_ms=ms6, library_device_ms=lib6, bound_share=row6["bound_ms"] / ms6,
                    pass_device_ms=by_pass, ctas=ctas6, grid=grids, workspace_mb=ws_mb)
        log(f"kernel device fused_subsample_bwd {label} B={B} T={T}: device_ms={ms6:.5f} ("
            + " ".join(f"{k}={v:.5f}" for k, v in by_pass.items())
            + f") library_device_ms={lib6:.5f} (the unfused cuDNN conv pair's backward) "
            f"bound_ms={row6['bound_ms']:.5f} bound_share={row6['bound_ms'] / ms6:.3f} "
            f"ctas={ctas6} grids={grids} rows/block: mask {plan['fwd_r2']}, conv1 "
            f"{plan['conv1_r2']}, dw2 {plan['dw2_rows']}; workspace {ws_mb:.1f} MB")


# kernel-name keys of the attention launches (csrc/attention_rows.cuh modes:
# 1 serving, 9 training forward with row statistics, 6 the backward's rowdot
# on them, 10 the backward's rowdot computing them)
ATTENTION_KERNELS = {
    "serving": ("rows_kernel<64, 1>",),
    "train": ("rows_kernel<64, 9>",),
    "bwd": ("rows_kernel<64, 6>", "bwd_kernel<64>", "bwd_reduce"),
    "bwd_alone": ("rows_kernel<64, 10>", "bwd_kernel<64>", "bwd_reduce"),
}


def _own_kernels(what, per, keys):
    """{key: device ms per call} of a wrapper call's kernels; raises unless
    the call ran exactly one kernel for each key and nothing else."""
    by_key = {key: [ms for name, ms in per.items() if key in name] for key in keys}
    if len(per) != len(keys) or any(len(v) != 1 for v in by_key.values()):
        raise AssertionError(f"{what}: device kernels {sorted(per)}, want one each of {keys}")
    return {key: v[0] for key, v in by_key.items()}


def checked_device_ms(what, fn, keys, iters: int = 20, tries: int = 3):
    """(device ms per call, {key: ms}, queued ms) of a wrapper call that must
    run one kernel for each of `keys` and nothing else; raises unless the
    profiler's sum lies within [0.7, 1.1] x the queued events' time of the
    same call. Both are taken after a spin of the card, so that it runs at
    its load clock. A pair that disagrees (one profiled launch delayed by
    something outside the call is enough at ten calls) is logged and both
    are taken again; it raises after `tries` such pairs, and only a pair that
    agrees is returned."""
    seen = []
    for _ in range(tries):
        torch.cuda.synchronize()
        torch.cuda._sleep(1 << 24)
        ms, per = device_ms(fn, iters=iters, per_kernel=True)
        parts = _own_kernels(what, per, keys)
        q_ms = queued_ms(fn, iters=iters)
        if 0.7 * q_ms <= ms <= 1.1 * q_ms:
            return ms, parts, q_ms
        pair = (f"profiler device_ms {ms:.5f} ("
                + " ".join(f"{k}={v:.5f}" for k, v in parts.items())
                + f") vs queued events' {q_ms:.5f} ms per call")
        log(f"{what}: {pair}: disagree, measured again")
        seen.append(pair)
    raise AssertionError(f"{what}: the profiler disagrees with the queued events in each of "
                         f"{tries} tries: " + "; ".join(seen))


def attention_device_phase(cfg, t_pad, t_valid, seed, rows):
    """Device time per launch (torch.profiler) of rows 3 and 4: row 3 at the
    serving shape (B=8, T'=512, no dropout) and, in its training form (which
    also writes the row statistics), at the train step's (B=16, T'=256,
    dropout 0.1); row 4 at the train step's on those statistics, per kernel
    (rowdot, gradients, reduce), and alone (computing them). Beside each:
    the unfused attention chain (forward; backward through autograd, its
    forward outside the timed region) and, as a second yardstick that is
    not the same function, F.scaled_dot_product_attention on the same q, k,
    v and key mask (the content term only; the port never calls it). Adds
    device_ms, train_device_ms (the row's 36 launches of a train step),
    library_device_ms, sdpa_device_ms, bound_share, CTAs, grids, shared
    bytes per CTA and row 4's workspace in MB to the rows. Each of the
    kernels' device times must lie within [0.7, 1.1] x the CUDA events' time
    of the same calls queued back to back (`checked_device_ms`). Run after
    every timed phase, as kernel_device_phase."""
    import torch.nn.functional as F

    from onebit_asr_tpu_torch.model.conformer import relpos_attention_chain
    from onebit_asr_tpu_torch.model.layers import fast_dropout
    from onebit_asr_tpu_torch.ops import attention as fa

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed + 3)
    H, dh, n = cfg.enc_heads, cfg.enc_d_model // cfg.enc_heads, cfg.enc_layers
    row3, row4 = rows["fused_relpos_attention"], rows["fused_relpos_attention_bwd"]
    serve_lens = np.concatenate([[t_valid], rng.integers(t_valid // 8, t_valid + 1, BATCH - 1)])
    step_lens = np.concatenate([[255], rng.integers(128, 256, 15)])
    for label, B, T, rate, lens in (("serving", BATCH, t_pad, 0.0, serve_lens),
                                    ("train step", 16, 256, 0.1, step_lens)):
        key_mask = torch.from_numpy(
            (np.arange(T)[None] < lens[:, None]).astype(np.float32)).to(dev)
        q, k, v, g = (torch.from_numpy(rng.standard_normal((B, H, T, dh)).astype(np.float32))
                      .to(dev).to(torch.bfloat16) for _ in range(4))
        p = torch.from_numpy(rng.standard_normal((H, 2 * T - 1, dh)).astype(np.float32))
        p = p.to(dev).to(torch.bfloat16)
        u, vb = (torch.from_numpy((0.1 * rng.standard_normal((H, dh))).astype(np.float32))
                 .to(dev).to(torch.bfloat16) for _ in range(2))
        drop8 = torch.from_numpy(
            rng.integers(0, 256, size=(B, H, T, T), dtype=np.uint8) if rate
            else np.zeros((1, 1, 1, 1), np.uint8)).to(dev)
        scale = 1.0 / float(np.sqrt(dh))
        ops = (q, k, v, p, u, vb, key_mask, drop8)
        plan = fa.launch_plan(B, H, T, dh)
        grid = [plan["tiles"], H, B]
        ctas = grid[0] * H * B
        chain_ops = [t.transpose(1, 2).contiguous() for t in (q, k, v)]
        chain_ops += [p.transpose(0, 1).contiguous(), u, vb]
        chain_extra = [key_mask > 0, scale]
        if rate:
            chain_extra.append(lambda a: fast_dropout(a, rate, drop8))
        sdpa_mask = (key_mask > 0)[:, None, None, :]

        def sdpa(q_, k_, v_):
            return F.scaled_dot_product_attention(q_, k_, v_, attn_mask=sdpa_mask,
                                                  dropout_p=rate, scale=scale)

        kind = "serving" if label == "serving" else "train"
        with torch.no_grad():
            fwd = ((lambda: fa.fused_relpos_attention(*ops, scale, rate)) if kind == "serving"
                   else (lambda: fa._fwd(*ops, scale, rate, stats=True)))
            ms, _, q_ms = checked_device_ms(f"fused_relpos_attention {label}", fwd,
                                            ATTENTION_KERNELS[kind])
            lib_ms, _ = device_ms(lambda: relpos_attention_chain(*chain_ops, *chain_extra))
            sdpa_ms, sdpa_names = device_ms(lambda: sdpa(q, k, v))
        P, bhtd = 2 * T - 1, B * H * T * dh
        f_bytes = (4 * bhtd * 2 + H * P * dh * 2 + 2 * H * dh * 2 + B * T * 4
                   + (B * H * T * T if rate else 0)) / HBM_BYTES_PER_S * 1e3
        f_ops = 2.0 * B * H * T * (3 * T) * dh / PEAK_OPS["bf16"] * 1e3
        bound = max(f_bytes, f_ops)
        log(f"kernel device fused_relpos_attention {label} ({kind} form) B={B} H={H} T={T} "
            f"dh={dh} rate={rate}: device_ms={ms:.5f} per launch (queued events "
            f"{q_ms:.5f}), library_device_ms="
            f"{lib_ms:.5f} (unfused attention chain) sdpa_device_ms={sdpa_ms:.5f} "
            f"(F.scaled_dot_product_attention, content term only: not the same function; "
            f"{', '.join(x[:50] for x in sdpa_names)}) bound_ms={bound:.5f} "
            f"bound_share={bound / ms:.3f} ctas={ctas} grid={grid} threads/CTA="
            f"{plan['rows_threads']} smem/CTA={plan['rows_smem']} B")
        if kind == "serving":
            row3.update(device_ms=n * ms, library_device_ms=n * lib_ms,
                        sdpa_device_ms=n * sdpa_ms, bound_share=row3["bound_ms"] / (n * ms),
                        ctas=ctas, grid=grid, smem_bytes=plan["rows_smem"])
            continue
        row3.update(train_device_ms=3 * n * ms, train_launch_device_ms=ms,
                    train_library_device_ms=lib_ms, train_bound_share=bound / ms)

        # row 4 on the training forward's row statistics (the main path), and alone
        _, stats = fa._fwd(*ops, scale, rate, stats=True)
        ms4, parts, q4 = checked_device_ms(
            f"fused_relpos_attention_bwd {label}",
            lambda: fa.fused_relpos_attention_bwd(*ops, g, scale, rate, stats=stats),
            ATTENTION_KERNELS["bwd"], iters=10)
        ms4a, parts_a, q4a = checked_device_ms(
            f"fused_relpos_attention_bwd {label} alone",
            lambda: fa.fused_relpos_attention_bwd(*ops, g, scale, rate),
            ATTENTION_KERNELS["bwd_alone"], iters=10)
        leaves = [t.clone().requires_grad_(True) for t in chain_ops]
        chain_out = relpos_attention_chain(*leaves, *chain_extra)
        g_chain = g.transpose(1, 2)
        lib4, _ = device_ms(lambda: torch.autograd.grad(chain_out, leaves, g_chain,
                                                        retain_graph=True), iters=10)
        del chain_out, leaves
        qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
        sdpa_out = sdpa(*qkv)
        sdpa4, _ = device_ms(lambda: torch.autograd.grad(sdpa_out, qkv, g, retain_graph=True),
                             iters=10)
        del sdpa_out, qkv
        ws_mb = plan["workspace_floats"] * 4 / 1e6
        names = ("rowdot", "gradients", "reduce")
        row4.update(device_ms=ms4, train_device_ms=3 * n * ms4, library_device_ms=lib4,
                    sdpa_device_ms=sdpa4, bound_share=row4["bound_ms"] / ms4,
                    kernel_device_ms=dict(zip(names, parts.values())),
                    alone_device_ms=ms4a, ctas={"rowdot": ctas, "gradients": ctas},
                    grid={"rowdot": grid, "gradients": grid},
                    smem_bytes={"rowdot": plan["rows_smem"], "gradients": plan["bwd_smem"]},
                    workspace_mb=ws_mb)
        log(f"kernel device fused_relpos_attention_bwd {label} B={B} H={H} T={T} dh={dh} "
            f"rate={rate}: device_ms={ms4:.5f} per launch on the forward's row statistics ("
            + " ".join(f"{k}={v:.5f}" for k, v in zip(names, parts.values()))
            + f"; queued events {q4:.5f}); alone device_ms={ms4a:.5f} ("
            + " ".join(f"{k}={v:.5f}" for k, v in zip(names, parts_a.values()))
            + f"; queued events {q4a:.5f}) library_device_ms={lib4:.5f} (the unfused chain's backward) "
            f"sdpa_device_ms={sdpa4:.5f} (F.scaled_dot_product_attention's backward: not the "
            f"same function) bound_ms={row4['bound_ms']:.5f} bound_share="
            f"{row4['bound_ms'] / ms4:.3f} ctas={ctas}+{ctas} grid={grid} threads/CTA "
            f"{plan['rows_threads']}+{plan['bwd_threads']} smem/CTA {plan['rows_smem']}+"
            f"{plan['bwd_smem']} B; workspace {ws_mb:.1f} MB")


def subsample_kernel_phase(cfg, frames, seed, rows):
    """The fused subsampler kernel against its plain version at the path's
    shape: one forward of B=8 utterances of `frames` log-mel frames."""
    import torch.nn.functional as F

    from onebit_asr_tpu_torch.ops import subsampler as ss

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    B, T, Fd, C = BATCH, frames, cfg.input_dim, cfg.enc_d_model
    x, w1, b1, w2, b2 = (torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
        rng.standard_normal((B, T, Fd)),
        rng.standard_normal((3, 3, C)) / 3.0,
        rng.uniform(-1 / 3, 1 / 3, C),
        rng.standard_normal((9 * C, C)) / np.sqrt(9 * C),
        rng.uniform(-1, 1, C) / np.sqrt(9 * C),
    ))
    w2 = w2.to(torch.bfloat16)
    out = ss.fused_subsample(x, w1, b1, w2, b2)
    ref = ss.fused_subsample_reference(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    d = (out.float() - ref.float()).abs()
    err = d.max().item()
    same = (out == ref).float().mean().item()
    if not bool((d <= 1e-3 + 2.0 ** -7 * ref.float().abs()).all()):
        raise AssertionError(f"fused_subsample: max |d| {err} over one bf16 ulp")
    # the port's unfused path: bf16 features -> two cuDNN convs + ReLU
    w1c = w1.permute(2, 0, 1)[:, None].to(torch.bfloat16)
    w2c = w2.reshape(3, 3, C, C).permute(3, 2, 0, 1).contiguous()
    b1c, b2c = b1.to(torch.bfloat16), b2.to(torch.bfloat16)

    def unfused():
        y = F.relu(F.conv2d(x[:, None].to(torch.bfloat16), w1c, b1c, stride=2))
        return F.relu(F.conv2d(y, w2c, b2c, stride=2))

    ms = cuda_ms(lambda: ss.fused_subsample(x, w1, b1, w2, b2))
    plain_ms = cuda_ms(lambda: ss.fused_subsample_reference(x, w1, b1, w2, b2))
    lib_ms = cuda_ms(unfused)
    T2, F2 = out.shape[1], out.shape[2]
    T1, F1 = ss.out_len(T), ss.out_len(Fd)
    nbytes = x.numel() * 4 + out.numel() * 2 + w2.numel() * 2 + (11 * C) * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_conv2 = 2.0 * B * T2 * F2 * C * 9 * C / PEAK_OPS["bf16"] * 1e3
    t_conv1 = 2.0 * B * T1 * F1 * C * 9 / PEAK_OPS["f32"] * 1e3
    bound = max(t_bytes, t_conv2, t_conv1)  # tensor and CUDA cores may overlap
    log(f"kernel fused_subsample B={B} T={T} F={Fd} C={C} -> T2={T2} F2={F2} x1/forward: "
        f"max|d|={err:.3g} bit_identical={same:.4f} ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"bound_ms={bound:.4f} (bytes {t_bytes:.4f}, conv2 bf16 {t_conv2:.4f}, "
        f"conv1 f32 {t_conv1:.4f}) library_ms={lib_ms:.4f} (unfused cuDNN convs)")
    rows["fused_subsample"] = {
        "name": "fused_subsample",
        "route": "cuda",
        "source": "onebit_asr_tpu_torch/csrc/subsampler.cu",
        "replaces": "onebit_asr_tpu/ops/subsampler.py:217",
        "launches": 0,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": "bytes" if t_bytes >= max(t_conv2, t_conv1) else "operations",
        "library_ms": lib_ms,
    }


def unfused_subsample(x, w1, b1, w2, b2, compute_dtype=torch.bfloat16):
    """The port's unfused conv pair (features cast to the compute dtype
    before conv1, two cuDNN convs + ReLU) with `fused_subsample`'s signature
    and output layout [B, T2, F2, C]: a yardstick, differentiable in all
    five operands."""
    import torch.nn.functional as F

    C, cd = w1.shape[-1], compute_dtype
    y = F.relu(F.conv2d(x[:, None].to(cd), w1.permute(2, 0, 1)[:, None].to(cd), b1.to(cd),
                        stride=2))
    y = F.relu(F.conv2d(y, w2.reshape(3, 3, C, C).permute(3, 2, 0, 1).to(cd), b2.to(cd),
                        stride=2))
    return y.permute(0, 2, 3, 1)


SUBSAMPLE_GRADS = ("dx", "dw1", "db1", "dw2", "db2")
MASK_SLACK = 2.0 ** -14  # of |pat| |w2| + |b2|: y_pre this close to 0 may fall either way


def subsample_bwd_kernel_phase(cfg, seed, rows):
    """The fused subsampler backward kernel (row 6) against its plain version
    at the train step's shape (one launch per branch of bench.py's batch:
    B=16, T=1024), on a ragged T (T2=25, not a multiple of the 4-row block)
    and at Conformer-S's C=144, in two halves: the masked cotangent gm must
    equal the plain version's except where y_pre is within f32 rounding of
    0, and the five gradients must match the plain backward applied to the
    kernel's own gm (dx, dw1, db1 within one bf16 ulp of the element plus one
    of the tensor's largest: a dpat element may round the other way; dw2,
    db2 within 1e-4 of it: f32 sums in another order). Two launches must
    give the same bits. Timed beside its bound, its plain version, the
    unfused conv pair's backward through autograd, and row 5's forward."""
    from onebit_asr_tpu_torch.ops import subsampler as ss

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed)
    Fd, C_path = cfg.input_dim, cfg.enc_d_model
    max_err = 0.0
    for label, B, T, C in (("step", 16, 1024, C_path), ("ragged", 3, 103, C_path),
                           ("conformer_s", 2, 600, 144)):
        T2, F2 = ss.out_len(ss.out_len(T)), ss.out_len(ss.out_len(Fd))
        ops, g = _subsample_case(rng, B, T, Fd, C, dev)
        x, w1, b1, w2, b2 = ops
        out = ss.fused_subsample_bwd(*ops, g)
        again = ss.fused_subsample_bwd(*ops, g)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(out, again)):
            raise AssertionError(f"fused_subsample_bwd {label}: two launches differ")
        gm = ss.masked_cotangent(*ops, g)
        gm_ref, y_pre = ss.masked_cotangent_reference(*ops, g)
        _, pat, _ = ss._pre_activations(*ops, torch.bfloat16)
        scale = pat.float() @ w2.to(torch.bfloat16).float().abs() + b2.abs()
        del pat
        differ = gm.float() != gm_ref
        if not bool((y_pre.abs()[differ] <= MASK_SLACK * scale[differ]).all()):
            raise AssertionError(f"fused_subsample_bwd {label}: the mask differs where y_pre "
                                 f"is not within f32 rounding of 0")
        n_differ = int(differ.sum())
        del gm_ref, y_pre, scale, differ
        want = ss.bwd_of_masked_reference(*ops, gm)
        whole = ss.fused_subsample_bwd_reference(*ops, g)
        errs = []
        for name, a, r, w, tol in zip(SUBSAMPLE_GRADS, out, want, whole,
                                      (2.0 ** -7,) * 3 + (1e-4,) * 2):
            if a.dtype != torch.float32 or a.shape != r.shape:
                raise AssertionError(f"fused_subsample_bwd {label} {name}: {a.dtype} "
                                     f"{tuple(a.shape)}")
            d = (a - r).abs()
            if not bool(torch.isfinite(a).all()) or not bool(
                    (d <= tol * (r.abs() + r.abs().max())).all()):
                raise AssertionError(f"fused_subsample_bwd {label} {name}: max |d| "
                                     f"{d.max().item()} (max |ref| {r.abs().max().item()})")
            dw = (a - w).abs().max().item()
            max_err = max(max_err, dw)
            errs.append(f"{name}={d.max().item():.3g}|{dw:.3g}/{r.abs().max().item():.3g}")
        log(f"kernel fused_subsample_bwd {label} B={B} T={T} F={Fd} C={C} -> T2={T2} F2={F2}: "
            f"max|d| vs the plain rest on the kernel's gm | vs the whole plain version / "
            f"max|ref|: {' '.join(errs)}; gm elements off the plain mask {n_differ} of "
            f"{gm.numel()}; two launches bit-identical; workspace "
            f"{ss.bwd_workspace_floats(B, T, Fd, C) * 4 / 1e6:.1f} MB")
        del want, whole, gm
        if label != "step":
            continue
        w2b = w2.to(torch.bfloat16)
        ms = cuda_ms(lambda: ss.fused_subsample_bwd(*ops, g))
        plain_ms = cuda_ms(lambda: ss.fused_subsample_bwd_reference(*ops, g), iters=5, warmup=1)
        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: ss.fused_subsample(x, w1, b1, w2b, b2))
        # the port's unfused conv pair on the same operands, its forward outside
        # the timed region
        leaves = [t.clone().requires_grad_(True) for t in ops]
        y = unfused_subsample(*leaves)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(y, leaves, g, retain_graph=True))
        del y, leaves
        T1, F1 = ss.out_len(T), ss.out_len(Fd)
        # x, g, w1, b1, w2 (bf16), b2 in; dx, dw1, db1, dw2, db2 (f32) out
        nbytes = 2 * x.numel() * 4 + g.numel() * 2 + w2.numel() * (2 + 4) + 2 * 11 * C * 4
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        # y_pre = pat w2, dpat = gm w2^T, dw2 = pat^T gm
        t_conv2 = 3 * 2.0 * B * T2 * F2 * 9 * C * C / PEAK_OPS["bf16"] * 1e3
        # conv1 recomputed, dw1, dx
        t_conv1 = 3 * 2.0 * B * T1 * F1 * 9 * C / PEAK_OPS["f32"] * 1e3
        bound = max(t_bytes, t_conv2, t_conv1)  # tensor and CUDA cores may overlap
        log(f"kernel fused_subsample_bwd {label}: per launch ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} bound_ms={bound:.4f} (bytes {t_bytes:.4f}, conv2 bf16 "
            f"{t_conv2:.4f}, conv1 f32 {t_conv1:.4f}) library_ms={lib_ms:.4f} (the unfused "
            f"cuDNN conv pair's backward through autograd); x3/train step")
        f_bytes = x.numel() * 4 + g.numel() * 2 + w2.numel() * 2 + 11 * C * 4  # y as g
        f_bound = max(f_bytes / HBM_BYTES_PER_S * 1e3, t_conv2 / 3, t_conv1 / 3)
        log(f"kernel fused_subsample (row 5) at the train step's shape B={B} T={T}: per launch "
            f"ms={fwd_ms:.4f} bound_ms={f_bound:.4f}; x3/train step")
        rows["fused_subsample_bwd"] = {
            "name": "fused_subsample_bwd",
            "route": "cuda",
            "source": "onebit_asr_tpu_torch/csrc/subsampler.cu",
            "replaces": "onebit_asr_tpu/ops/subsampler.py:244",
            "launches": 0,
            "max_abs_err": 0.0,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= max(t_conv2, t_conv1) else "operations",
            "library_ms": lib_ms,
        }
    rows["fused_subsample_bwd"]["max_abs_err"] = max_err


def attention_kernel_phase(cfg, t_pad, t_valid, seed, rows):
    """The fused attention kernel against its plain version at the path's
    shape (one launch per block of a B=8 forward), at dh=36 and with
    dropout."""
    from onebit_asr_tpu_torch.model.conformer import relpos_attention_chain
    from onebit_asr_tpu_torch.ops import attention as fa

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    B, H, T = BATCH, cfg.enc_heads, t_pad
    dh_path = cfg.enc_d_model // H
    n = cfg.enc_layers
    lens = np.concatenate([[t_valid], rng.integers(t_valid // 8, t_valid + 1, B - 1)])
    key_mask = torch.from_numpy(
        (np.arange(T)[None] < lens[:, None]).astype(np.float32)).to(dev)
    max_err = 0.0
    for label, dh, rate in (("path", dh_path, 0.0), ("conformer_s", 36, 0.0),
                            ("dropout", dh_path, 0.1)):
        q, k, v = (rng.standard_normal((B, H, T, dh)) for _ in range(3))
        p = rng.standard_normal((H, 2 * T - 1, dh))
        u, vb = (0.1 * rng.standard_normal((H, dh)) for _ in range(2))
        q, k, v, p, u, vb = (torch.from_numpy(a.astype(np.float32)).to(dev).to(torch.bfloat16)
                             for a in (q, k, v, p, u, vb))
        drop8 = torch.from_numpy(
            rng.integers(0, 256, size=(B, H, T, T), dtype=np.uint8) if rate
            else np.zeros((1, 1, 1, 1), np.uint8)).to(dev)
        scale = 1.0 / float(np.sqrt(dh))
        ops = (q, k, v, p, u, vb, key_mask, drop8, scale, rate)
        out = fa.fused_relpos_attention(*ops)
        ref = fa.fused_relpos_attention_reference(*ops)
        torch.cuda.synchronize()
        d = (out.float() - ref.float()).abs()
        err = d.max().item()
        same = (out == ref).float().mean().item()
        if not bool((d <= 1e-2 + 2.0 ** -7 * ref.float().abs()).all()):
            raise AssertionError(f"fused_relpos_attention {label}: max |d| {err} over tolerance")
        max_err = max(max_err, err)
        ms = cuda_ms(lambda: fa.fused_relpos_attention(*ops))
        plain_ms = cuda_ms(lambda: fa.fused_relpos_attention_reference(*ops))
        P = 2 * T - 1
        nbytes = (B * H * T * dh * 2 * 4 + H * P * dh * 2 + 2 * H * dh * 2 + B * T * 4
                  + (B * H * T * T if rate else 0))
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        # qu k^T, the T x T skewed band of qv p^T, attn v (the TPU kernel's
        # CostEstimate counts its full [T, P] qv p^T instead)
        t_ops = 2.0 * B * H * T * (3 * T) * dh / PEAK_OPS["bf16"] * 1e3
        bound = max(t_bytes, t_ops)
        lib = ""
        if label == "path":
            # the port's unfused chain on the same operands, [B, T, H, dh]
            chain_ops = (q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                         v.transpose(1, 2).contiguous(), p.transpose(0, 1).contiguous(),
                         u, vb, key_mask > 0, scale)
            lib_ms = cuda_ms(lambda: relpos_attention_chain(*chain_ops))
            chain = relpos_attention_chain(*chain_ops).transpose(1, 2)
            chain_err = (chain.float() - ref.float()).abs().max().item()
            lib = (f" library_ms={lib_ms:.4f} (unfused attention chain; its max|d| to the "
                   f"plain version {chain_err:.3g})")
            rows["fused_relpos_attention"] = {
                "name": "fused_relpos_attention",
                "route": "cuda",
                "source": "onebit_asr_tpu_torch/csrc/attention.cu",
                "replaces": "onebit_asr_tpu/ops/attention.py:141",
                "launches": 0,
                "max_abs_err": 0.0,
                "ms": n * ms,
                "plain_ms": n * plain_ms,
                "bound_ms": n * bound,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": n * lib_ms,
            }
        log(f"kernel fused_relpos_attention {label} B={B} H={H} T={T} dh={dh} rate={rate}: "
            f"max|d|={err:.3g} bit_identical={same:.4f} per launch: ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} bound_ms={bound:.4f} (bytes {t_bytes:.4f}, "
            f"bf16 {t_ops:.4f}){lib}; x{n}/forward at the path's shape")
    rows["fused_relpos_attention"]["max_abs_err"] = max_err


GRADS = ("dq", "dk", "dv", "dp", "du", "dvb")


def attention_bwd_kernel_phase(cfg, seed, rows):
    """The fused attention backward kernel against its plain version at the
    train step's shape (one launch per block and branch of bench.py's batch)
    with dropout 0.1 and 0, on a ragged case with an all-pad row and at
    dh=36, with row 3's training form (output and row statistics) held at
    each; timed beside its bound and the unfused chain's backward, with
    row 3's forward timed at the same shape."""
    from onebit_asr_tpu_torch.model.conformer import relpos_attention_chain
    from onebit_asr_tpu_torch.model.layers import fast_dropout
    from onebit_asr_tpu_torch.ops import attention as fa

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed)
    H, dh_path = cfg.enc_heads, cfg.enc_d_model // cfg.enc_heads
    step_lens = np.concatenate([[255], rng.integers(128, 256, 15)])
    # (label, B, H, T, dh, key lengths, dropout rate, g zero on padded rows)
    cases = [("step", 16, H, 256, dh_path, step_lens, 0.1, True),
             ("step_no_dropout", 16, H, 256, dh_path, step_lens, 0.0, True),
             ("ragged", 3, H, 255, dh_path, [250, 0, 255], 0.1, False),
             ("conformer_s", 2, 2, 200, 36, [200, 131], 0.0, False)]
    max_err = 0.0
    for label, B, Hc, T, dh, lens, rate, zero_pad in cases:
        key_mask = torch.from_numpy(
            (np.arange(T)[None] < np.asarray(lens)[:, None]).astype(np.float32)).to(dev)
        q, k, v, g = (rng.standard_normal((B, Hc, T, dh)) for _ in range(4))
        p = rng.standard_normal((Hc, 2 * T - 1, dh))
        u, vb = (0.1 * rng.standard_normal((Hc, dh)) for _ in range(2))
        q, k, v, g, p, u, vb = (torch.from_numpy(a.astype(np.float32)).to(dev).to(torch.bfloat16)
                                for a in (q, k, v, g, p, u, vb))
        if zero_pad:  # the block masks its output, so padded queries get no gradient
            g = g * key_mask[:, None, :, None].to(g.dtype)
        drop8 = torch.from_numpy(
            rng.integers(0, 256, size=(B, Hc, T, T), dtype=np.uint8) if rate
            else np.zeros((1, 1, 1, 1), np.uint8)).to(dev)
        scale = 1.0 / float(np.sqrt(dh))
        ops = (q, k, v, p, u, vb, key_mask, drop8)
        out = fa.fused_relpos_attention_bwd(*ops, g, scale, rate)
        again = fa.fused_relpos_attention_bwd(*ops, g, scale, rate)
        trained, stats = fa._fwd(*ops, scale, rate, stats=True)
        saved = fa.fused_relpos_attention_bwd(*ops, g, scale, rate, stats=stats)
        ref = fa.fused_relpos_attention_bwd_reference(*ops, g, scale, rate)
        torch.cuda.synchronize()
        # row 3's training form, which the step runs: its output as phase 2
        # holds the serving form (and the same bits), its row statistics as
        # the card tests do (the same products summed in another f32 order)
        if not torch.equal(trained, fa._fwd(*ops, scale, rate)):
            raise AssertionError(f"fused_relpos_attention {label}: the training form's output "
                                 f"differs from the serving form's")
        f_ref = fa.fused_relpos_attention_reference(*ops, scale, rate).float()
        d = (trained.float() - f_ref).abs()
        if not bool((d <= 1e-2 + 2.0 ** -7 * f_ref.abs()).all()):
            raise AssertionError(f"fused_relpos_attention {label} (training form): max |d| "
                                 f"{d.max().item()} over tolerance")
        f_err = d.max().item()
        m_ref, l_ref = fa.row_stats_reference(q, k, p, u, vb, key_mask, scale)
        m_d, l_d = (stats[0] - m_ref).abs(), (stats[1] - l_ref).abs()
        if not (bool((m_d <= 1e-4 * (1 + m_ref.abs())).all())
                and bool((l_d <= 1e-4 * l_ref).all())):
            raise AssertionError(f"fused_relpos_attention {label}: row statistics max |d| m "
                                 f"{m_d.max().item()} l {l_d.max().item()} over tolerance")
        m_err = (m_d / (1 + m_ref.abs())).max().item()
        l_err = (l_d / l_ref).max().item()
        del f_ref, m_ref, l_ref, m_d, l_d
        row3 = rows["fused_relpos_attention"]
        row3["train_max_abs_err"] = max(row3.get("train_max_abs_err", 0.0), f_err)
        row3["max_abs_err"] = max(row3["max_abs_err"], f_err)
        row3["stats_max_rel_err"] = max(row3.get("stats_max_rel_err", 0.0), m_err, l_err)
        log(f"kernel fused_relpos_attention {label} (training form) B={B} H={Hc} T={T} dh={dh} "
            f"rate={rate}: max|d|={f_err:.3g}, the serving form's bits; row statistics "
            f"|d|/(1+|m|) {m_err:.3g}, |d|/l {l_err:.3g} (limit 1e-4)")
        if not all(torch.equal(a, b) for a, b in zip(out, again)):
            raise AssertionError(f"fused_relpos_attention_bwd {label}: two launches differ")
        if not all(torch.equal(a, b) for a, b in zip(out, saved)):
            raise AssertionError(f"fused_relpos_attention_bwd {label}: the backward on the "
                                 f"forward's row statistics differs from the one computing them")
        errs, same, n = [], 0, 0
        for name, a, r in zip(GRADS, out, ref):
            if a.dtype != torch.bfloat16 or a.shape != r.shape:
                raise AssertionError(f"fused_relpos_attention_bwd {label} {name}: "
                                     f"{a.dtype} {tuple(a.shape)}")
            a, r = a.float(), r.float()
            d = (a - r).abs()
            if not bool(torch.isfinite(a).all()) or not bool(
                    (d <= 2.0 ** -7 * (r.abs() + r.abs().max())).all()):
                raise AssertionError(f"fused_relpos_attention_bwd {label} {name}: max |d| "
                                     f"{d.max().item()} (max |ref| {r.abs().max().item()})")
            errs.append(f"{name}={d.max().item():.3g}/{r.abs().max().item():.3g}")
            max_err = max(max_err, d.max().item())
            same += int((a == r).sum())
            n += a.numel()
        log(f"kernel fused_relpos_attention_bwd {label} B={B} H={Hc} T={T} dh={dh} "
            f"rate={rate}: max|d|/max|ref| {' '.join(errs)} bit_identical={same / n:.4f} "
            f"two launches and the one on the forward's row statistics bit-identical")
        if label != "step":
            continue
        # the main path: the backward on the row statistics the forward wrote
        ms = cuda_ms(lambda: fa.fused_relpos_attention_bwd(*ops, g, scale, rate, stats=stats))
        plain_ms = cuda_ms(lambda: fa.fused_relpos_attention_bwd_reference(*ops, g, scale, rate),
                           iters=5, warmup=1)
        # the port's unfused chain on the same operands and draws, [B, T, H, dh];
        # its forward outside the timed region
        leaves = [t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v)]
        leaves += [p.transpose(0, 1).contiguous().requires_grad_(True),
                   u.clone().requires_grad_(True), vb.clone().requires_grad_(True)]
        chain_out = relpos_attention_chain(*leaves, key_mask > 0, scale,
                                           lambda a: fast_dropout(a, rate, drop8))
        g_chain = g.transpose(1, 2)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(chain_out, leaves, g_chain,
                                                     retain_graph=True))
        del chain_out, leaves
        P, bhtd = 2 * T - 1, B * Hc * T * dh
        nbytes = (7 * bhtd * 2 + 2 * Hc * P * dh * 2 + 4 * Hc * dh * 2 + B * T * 4
                  + B * Hc * T * T)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        # qu k^T, the T x T band of qv p^T, g v^T, attn^T g, ds k, dbraw p,
        # ds^T qu, dbraw^T qv
        t_ops = 8 * 2.0 * B * Hc * T * T * dh / PEAK_OPS["bf16"] * 1e3
        with torch.no_grad():  # the training forward, which writes the row statistics
            fwd_ms = cuda_ms(lambda: fa._fwd(*ops, scale, rate, stats=True))
        f_bytes = (4 * bhtd * 2 + Hc * P * dh * 2 + B * T * 4 + B * Hc * T * T) / HBM_BYTES_PER_S
        f_ops = 2.0 * B * Hc * T * 3 * T * dh / PEAK_OPS["bf16"]
        log(f"kernel fused_relpos_attention_bwd {label}: per launch ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} bound_ms={max(t_bytes, t_ops):.5f} (bytes {t_bytes:.5f}, "
            f"bf16 {t_ops:.5f}) library_ms={lib_ms:.4f} (the unfused chain's backward through "
            f"autograd); x{3 * cfg.enc_layers}/train step")
        log(f"kernel fused_relpos_attention (row 3) at the train step's shape B={B} H={Hc} "
            f"T={T} dh={dh} rate={rate}: per launch ms={fwd_ms:.4f} "
            f"bound_ms={max(f_bytes, f_ops) * 1e3:.5f}; x{3 * cfg.enc_layers}/train step")
        rows["fused_relpos_attention_bwd"] = {
            "name": "fused_relpos_attention_bwd",
            "route": "cuda",
            "source": "onebit_asr_tpu_torch/csrc/attention_bwd.cu",
            "replaces": "onebit_asr_tpu/ops/attention.py:165",
            "launches": 0,
            "max_abs_err": 0.0,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms,
        }
    rows["fused_relpos_attention_bwd"]["max_abs_err"] = max_err


def synthetic_waveforms(seed: int):
    """8 waveforms of 2-16 s (one of exactly 16 s): tone mixtures + noise."""
    rng = np.random.default_rng(seed)
    secs = np.concatenate([[16.0], rng.uniform(2.0, 16.0, BATCH - 1)])
    wavs = []
    for s in secs:
        t = np.arange(int(s * SAMPLE_RATE)) / SAMPLE_RATE
        f = rng.uniform(100.0, 3000.0, size=4)
        w = sum(np.sin(2 * np.pi * fi * t + rng.uniform(0, 6.3)) for fi in f)
        w = 0.05 * w + 0.01 * rng.standard_normal(t.shape)
        wavs.append(w.astype(np.float32))
    return wavs


def pcm16(w: np.ndarray) -> np.ndarray:
    return (np.clip(w, -1, 1) * 32767).astype(np.int16)


def write_wavs(directory, wavs, names=None):
    """16-bit PCM mono wavs at 16 kHz, `utt<i>.wav` unless `names` given."""
    os.makedirs(directory)
    for i, w in enumerate(wavs):
        name = names[i] if names else f"utt{i}"
        with wave.open(os.path.join(directory, f"{name}.wav"), "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(SAMPLE_RATE)
            f.writeframes(pcm16(w).tobytes())


def write_cmvn(directory, cmvn):
    os.makedirs(directory)
    np.savez(os.path.join(directory, "cmvn_stats.npz"), mean=cmvn[0], std=cmvn[1])


def write_inputs(root, configs, params, wavs, cmvn):
    """The CLI's inputs: params .npz, one config.json per entry of
    `configs` ({name: ModelConfig}), cmvn, 16-bit PCM wavs."""
    from onebit_asr_tpu_torch.convert import flatten
    from onebit_asr_tpu_torch.utils.config import TrainConfig, config_to_json

    paths = {k: os.path.join(root, k) for k in ("params.npz", "data", "wavs")}
    np.savez(paths["params.npz"], **flatten(params))
    for name, cfg in configs.items():
        paths[name] = os.path.join(root, f"{name}.json")
        with open(paths[name], "w") as f:
            f.write(config_to_json(TrainConfig(model=cfg)))
    write_cmvn(paths["data"], cmvn)
    write_wavs(paths["wavs"], wavs)
    return paths


def pad_batch(wavs):
    lens = np.array([len(w) for w in wavs], np.int32)
    batch = np.zeros((len(wavs), lens.max()), np.float32)
    for i, w in enumerate(wavs):
        batch[i, : len(w)] = w
    return batch, lens


def pcm_batch(wavs):
    """The waveforms as the CLI reads them (16-bit PCM), padded into one
    batch: both paths see one input."""
    return pad_batch([pcm16(w).astype(np.float32) / 32768.0 for w in wavs])


def cmvn_of(batch, lens):
    """(mean, std) per mel bin over the valid frames of a batch."""
    from onebit_asr_tpu_torch.ops.frontend import LogMelFrontend

    feats, flens = LogMelFrontend()(torch.from_numpy(batch).cuda(), torch.from_numpy(lens).cuda())
    v = feats[torch.arange(feats.shape[1], device="cuda")[None] < flens[:, None]]
    return v.mean(0).cpu().numpy(), v.std(0).clamp(min=1e-8).cpu().numpy()


DATA_ALPHABET = "ABCDEFGHIJKLMNOPQRSTUVW"  # with the word marker, 24 pieces:
# the 4 reserved ones make a subword vocabulary of 28, a model vocabulary of 32


def write_char_tokenizer(directory, alphabet=DATA_ALPHABET):
    """A character-level SentencePiece tokenizer.model in `directory`: the
    4 reserved pieces, the word marker and `alphabet` (DATA_ALPHABET: model
    vocabulary 32, the synthetic backend's). No piece merges, so a text encodes to one
    piece per character. Decoding is lossy: model ids 0-3 are dropped, and
    4, 6 and 7 (the control pieces) decode to nothing, so a comparison of
    what a CLI served holds its ids (`decoded_ids`), not only its text."""
    from onebit_asr_tpu_torch.data import spm

    pieces = [("<blank>", 0.0, spm.CONTROL), ("<unk>", 0.0, spm.UNKNOWN),
              ("<sos>", 0.0, spm.CONTROL), ("<eos>", 0.0, spm.CONTROL),
              (spm.SPACE, 0.0, spm.NORMAL)]
    pieces += [(c, 0.0, spm.NORMAL) for c in alphabet]
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "tokenizer.model")
    with open(path, "wb") as f:
        f.write(spm.write_model_proto(pieces))
    return path


DATA_SPLITS = (("train", 48), ("dev", 8), ("test", 8))


def write_data_dir(root, seed, splits=DATA_SPLITS, seconds=(2.0, 10.0), device=None,
                   cached=True):
    """A seeded data dir `root/data` in the layout the data module reads:
    per split a manifest (the port's `write_manifest`) and one npz shard of
    waveforms keyed by utt_id, durations spread evenly over `seconds` (tone
    mixtures + noise), texts of words over DATA_ALPHABET (~3 characters a
    second), token ids in the manifest for every other row (the data module
    encodes the rest), a character-level tokenizer.model, and
    cmvn_stats.npz over the train split by the port's frontend on `device`
    (default DEVICE). With `cached`, `root/cached` is a copy whose manifests
    carry a float16 feature cache (one `{split}_feats.npy` per split, CMVN
    applied), as a prepare-time cache does. Returns (data dir, cached dir or
    None)."""
    from onebit_asr_tpu_torch.data import Utterance, write_manifest
    from onebit_asr_tpu_torch.data.text import AsrTokenizer
    from onebit_asr_tpu_torch.ops.frontend import LogMelFrontend, apply_cmvn

    device = device or DEVICE
    rng = np.random.default_rng(seed + 14)
    data = os.path.join(root, "data")
    tok = AsrTokenizer.load(write_char_tokenizer(data))
    fe = LogMelFrontend()
    manifests, wavs = {}, {}
    for split, n in splits:
        secs = rng.permutation(np.linspace(seconds[0], seconds[1], n))
        shard = f"{split}_shard00000.npz"
        utts = []
        for i, sec in enumerate(secs):
            uid = f"{split}-{i:06d}"
            t = np.arange(int(sec * SAMPLE_RATE) + int(rng.integers(0, 160))) / SAMPLE_RATE
            w = sum(np.sin(2 * np.pi * f * t + rng.uniform(0, 6.3))
                    for f in rng.uniform(100.0, 3000.0, size=3))
            wavs[uid] = (0.05 * w + 0.01 * rng.standard_normal(t.shape)).astype(np.float32)
            words, chars = [], int(3 * sec)
            while sum(map(len, words)) < chars:
                words.append("".join(rng.choice(list(DATA_ALPHABET), rng.integers(2, 7))))
            text = " ".join(words)
            utts.append(Utterance(utt_id=uid, shard=shard, index=i,
                                  num_samples=len(wavs[uid]), text=text,
                                  tokens=tok.encode(text) if i % 2 == 0 else []))
        np.savez(os.path.join(data, shard), **{u.utt_id: wavs[u.utt_id] for u in utts})
        write_manifest(os.path.join(data, f"{split}_manifest.jsonl"), utts)
        manifests[split] = utts

    feats = {}
    for uid, w in wavs.items():
        w = torch.from_numpy(w)[None].to(device)
        feats[uid] = fe(w, torch.tensor([w.shape[1]], device=device))[0][0]
    v = torch.cat([feats[u.utt_id] for u in manifests["train"]]).double()
    cmvn = (v.mean(0).float(), v.std(0, correction=0).clamp(min=1e-8).float())
    np.savez(os.path.join(data, "cmvn_stats.npz"), mean=cmvn[0].cpu().numpy(),
             std=cmvn[1].cpu().numpy())
    if not cached:
        return data, None

    cache = os.path.join(root, "cached")
    os.makedirs(cache)
    for name in os.listdir(data):
        if not name.endswith("_manifest.jsonl"):
            shutil.copy(os.path.join(data, name), cache)
    for split, utts in manifests.items():
        fs = [apply_cmvn(feats[u.utt_id], *cmvn).half().cpu().numpy() for u in utts]
        offsets = np.cumsum([0] + [len(f) for f in fs])
        np.save(os.path.join(cache, f"{split}_feats.npy"), np.concatenate(fs))
        write_manifest(os.path.join(cache, f"{split}_manifest.jsonl"), [
            dataclasses.replace(u, feat_shard=f"{split}_feats.npy", feat_index=int(o),
                                num_frames=len(f))
            for u, f, o in zip(utts, fs, offsets)])
    return data, cache


def _use_plain(model, int8_act):
    """Point every kernel wrapper of `model` at its plain version."""
    from onebit_asr_tpu_torch.model.conformer import RelPosMHSA
    from onebit_asr_tpu_torch.model.layers import QuantDense
    from onebit_asr_tpu_torch.ops import attention as fa
    from onebit_asr_tpu_torch.ops import subsampler as ss
    from onebit_asr_tpu_torch.ops import ternary_matmul as tm

    plain = tm.ternary_matmul_w2a8_reference if int8_act else tm.ternary_matmul_reference
    for m in model.modules():
        if isinstance(m, QuantDense):
            m.matmul = plain
        elif isinstance(m, RelPosMHSA):
            m.attention_fn = fa.fused_relpos_attention_reference
    model.encoder.subsample.subsample_fn = ss.fused_subsample_reference


def _compare(name, lp, lp_ref, enc_lens, vocab, pad_multiple):
    """max/mean |d log p| and argmax agreement on valid frames."""
    T = lp.shape[1]
    if lp.shape != (BATCH, T, vocab) or T % pad_multiple:
        raise AssertionError(f"{name}: log-probs shape {tuple(lp.shape)}")
    mask = torch.arange(T, device=lp.device)[None] < enc_lens[:, None]
    if not bool(torch.isfinite(lp[mask]).all()):
        raise AssertionError(f"{name}: non-finite log-probs")
    d = (lp - lp_ref).abs()[mask]
    agree = (lp.argmax(-1) == lp_ref.argmax(-1))[mask].float().mean().item()
    return mask, d.max().item(), d.mean().item(), agree


def check_variant(name, t, int8_act, batch, lens, kernels):
    """ms per batch, peak memory and kernel launches per batch of Transcriber
    `t` on the kernels, then its CTC log-probs against the same model on the
    plain versions."""
    cfg = t.cfg.model
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: t.transcribe(batch, lens), iters=5, warmup=1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _reset(kernels)
    t.transcribe(batch, lens)
    launched = _counts(kernels)
    lp, enc_lens = t.log_probs(batch, lens)
    ids, n_ids = t.transcribe(batch, lens)
    if name == "ternary_matmul_bf16":
        # PyTorch's default lets cuDNN run the f32 depthwise conv in TF32
        torch.backends.cudnn.allow_tf32 = True
        lp_tf32, _ = t.log_probs(batch, lens)
        torch.backends.cudnn.allow_tf32 = False
        _, dmax, dmean, agree = _compare("tf32", lp_tf32, lp, enc_lens,
                                         cfg.vocab_size, cfg.time_pad_multiple)
        log(f"path tf32: cuDNN TF32 on (PyTorch default) vs off, bf16 kernel path: "
            f"logprob max|d|={dmax:.4g} mean|d|={dmean:.4g} argmax_agree={agree:.4f}")
    _use_plain(t.model, int8_act)
    lp_ref, _ = t.log_probs(batch, lens)
    ids_ref, n_ref = t.transcribe(batch, lens)
    mask, dmax, dmean, agree = _compare(name, lp, lp_ref, enc_lens,
                                        cfg.vocab_size, cfg.time_pad_multiple)
    same_ids = sum(
        int(n_ids[b] == n_ref[b] and (ids[b, : n_ids[b]] == ids_ref[b, : n_ref[b]]).all())
        for b in range(BATCH)
    )
    log(f"path {name}: audio_s={lens.sum() / SAMPLE_RATE:.2f} T'={lp.shape[1]} "
        f"valid_frames={int(mask.sum())} "
        f"logprob max|d|={dmax:.4g} mean|d|={dmean:.4g} "
        f"argmax_agree={agree:.4f} same_greedy_ids={same_ids}/{BATCH} "
        f"ms_per_batch={ms:.2f} peak_mem_gb={peak_gb:.3f} launches_per_batch={launched}")
    if dmean > 0.05 or agree < 0.9:
        raise AssertionError(f"{name}: kernel path strays from the plain path")


def path_phase(cfg, params, wavs, rows):
    from onebit_asr_tpu_torch.cli import transcribe as cli
    from onebit_asr_tpu_torch.ops import attention as fa
    from onebit_asr_tpu_torch.ops import subsampler as ss
    from onebit_asr_tpu_torch.ops import ternary_matmul as tm
    from onebit_asr_tpu_torch.utils.config import TrainConfig

    batch, lens = pcm_batch(wavs)
    cmvn = cmvn_of(batch, lens)

    kernels = {"ternary_matmul_bf16": tm.ternary_matmul,
               "ternary_matmul_w2a8": tm.ternary_matmul_w2a8,
               "fused_subsample": ss.fused_subsample,
               "fused_relpos_attention": fa.fused_relpos_attention,
               "fused_relpos_attention_bwd": fa.fused_relpos_attention_bwd,
               "fused_subsample_bwd": ss.fused_subsample_bwd}
    configs = {
        "config": cfg,
        "config_fused": dataclasses.replace(cfg, fused_subsampler=True),
        "config_fused_attention": dataclasses.replace(
            cfg, fused_attention=True, fused_subsampler=True),
    }
    L = 9 * cfg.enc_layers
    # (label, config, extra CLI arguments, launches wanted per batch)
    runs = [
        ("ternary_matmul_bf16", "config", [], {"ternary_matmul_bf16": L}),
        ("ternary_matmul_w2a8", "config", ["--int8_act"], {"ternary_matmul_w2a8": L}),
        ("fused_subsampler", "config_fused", [],
         {"ternary_matmul_bf16": L, "fused_subsample": 1}),
        ("fused_attention", "config_fused_attention", [],
         {"ternary_matmul_bf16": L, "fused_subsample": 1,
          "fused_relpos_attention": cfg.enc_layers}),
        ("no_fused_kernels", "config_fused_attention", ["--no_fused_kernels"],
         {"ternary_matmul_bf16": L}),
    ]
    build_root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "onebit_asr_tpu_torch", "_build")
    os.makedirs(build_root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_root) as root:
        paths = write_inputs(root, configs, params, wavs, cmvn)

        def argv(config, extra, out):
            return ["--params", paths["params.npz"], "--config", paths[config],
                    "--wav_dir", paths["wavs"], "--data_dir", paths["data"],
                    "--batch_size", str(BATCH), "--out", out, "--packed", *extra]

        for label, config, extra, want in runs:
            out = os.path.join(root, f"hyp_{label}.tsv")
            _reset(kernels)
            t0 = time.perf_counter()
            rc = cli.main(argv(config, extra, out))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _counts(kernels)
            if rc != 0:
                raise AssertionError(f"transcribe CLI ({label}) returned {rc}")
            if counts != want:
                raise AssertionError(f"{label}: launches {counts}, want {want}")
            if label in rows:
                rows[label]["launches"] = counts[label]
            if label == "fused_subsampler":
                rows["fused_subsample"]["launches"] = counts["fused_subsample"]
            if label == "fused_attention":
                rows["fused_relpos_attention"]["launches"] = counts["fused_relpos_attention"]
            with open(out) as f:
                lines = [l.rstrip("\n").split("\t") for l in f]
            if len(lines) != BATCH or any(len(l) != 2 for l in lines):
                raise AssertionError(f"CLI wrote {len(lines)} lines, want {BATCH}")
            log(f"path cli {label}: rc=0 launches={counts} utterances={len(lines)} "
                f"wall_s={wall:.2f} (weights export + load + featurize + forward + decode)")

    variants = (
        ("ternary_matmul_bf16", cfg, False),
        ("ternary_matmul_w2a8", cfg, True),
        ("fused_subsampler", configs["config_fused"], False),
        ("fused", configs["config_fused_attention"], False),
    )
    for name, model_cfg, int8_act in variants:
        t = cli.Transcriber(TrainConfig(model=model_cfg), params, 2, int8_act, cmvn, "cuda")
        check_variant(name, t, int8_act, batch, lens, kernels)
        del t  # nothing of one variant stays allocated for the next

    def one_batch(model_cfg, int8_act):
        """One batch through a Transcriber built on the first call."""
        held = []

        def run():
            if not held:
                held.append(cli.Transcriber(TrainConfig(model=model_cfg), params, 2, int8_act,
                                            cmvn, "cuda"))
            return held[0].transcribe(batch, lens)
        return run

    # what to profile, run after every timed phase (the device phases
    # included): a finished profiler run can slow later host code and
    # change later profiles
    return [(f"one batch through {name}", one_batch(model_cfg, int8_act), 15)
            for name, model_cfg, int8_act in variants]


def _lattice_case(rng, B, T, U, V, t_valid, dev):
    """Emissions, lengths, skip mask and both init rows for random logits
    and labels; logit lengths up to `t_valid`, label lengths from U/2."""
    from onebit_asr_tpu_torch.losses import ctc as tctc

    logits = torch.from_numpy(rng.standard_normal((B, T, V)).astype(np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(4, V, (B, U))).to(dev)
    label_lens = torch.from_numpy(rng.integers(U // 2, U + 1, B)).to(dev)
    lens = torch.from_numpy(rng.integers(t_valid // 2, t_valid + 1, B)).to(dev)
    lens[0] = t_valid
    z, can_skip = tctc._extended_targets(labels, 3)
    emit, _ = tctc._emissions(logits, z)
    case = dict(logits=logits, labels=labels, label_lens=label_lens, lens=lens, emit=emit,
                skip=can_skip)
    return {**case, **_lattice_case_inits(case)}


def ctc_kernel_phase(seed, rows):
    """The CTC lattice kernels against their plain versions, and their times
    at the train step's shape."""
    import torch.nn.functional as F

    from onebit_asr_tpu_torch.losses import ctc as tctc
    from onebit_asr_tpu_torch.ops import ctc_lattice as cl

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed)
    cases = {
        # three branches of bench.py's batch: T' = 255 padded to 256
        "path": _lattice_case(rng, 48, 256, 48, 5004, 255, dev),
        # DataConfig.max_tokens = 228 labels; T' = 400 padded to 512
        "ceiling": _lattice_case(rng, 16, 512, 228, 5004, 400, dev),
        "ragged": _lattice_case(rng, 8, 37, 12, 7, 33, dev),
    }
    r = cases["ragged"]  # label length 0, and a row too short for its labels
    r["label_lens"][1] = 0
    r["label_lens"][2], r["lens"][2] = 12, 9
    r.update(_lattice_case_inits(r))
    errs = {"ctc_alpha": 0.0, "ctc_beta": 0.0}
    for label, c in cases.items():
        B, T, S = c["emit"].shape
        for name, fn, plain, init in (("ctc_alpha", cl.ctc_alpha, cl.ctc_alpha_reference, "alpha0"),
                                      ("ctc_beta", cl.ctc_beta, cl.ctc_beta_reference, "beta0")):
            ops = (c["emit"], c["lens"], c["skip"], c[init])
            out, ref = fn(*ops), plain(*ops)
            torch.cuda.synchronize()
            neg = ref <= cl.NEG_INF / 2
            if not torch.equal(out <= cl.NEG_INF / 2, neg):
                raise AssertionError(f"{name} {label}: NEG_INF entries differ from the plain version")
            d = (out - ref).abs()[~neg]
            err = d.max().item() if d.numel() else 0.0
            if not bool((d <= 1e-5 * ref.abs()[~neg] + 1e-5).all()):
                raise AssertionError(f"{name} {label}: max |d| {err} over 1e-5 relative")
            errs[name] = max(errs[name], err)
            same = (out == ref).float().mean().item()
            if not torch.equal(out, ref):
                raise AssertionError(f"{name} {label}: not bit-identical to the plain version "
                                     f"(share {same:.6f})")
            timed = f" ms={cuda_ms(lambda: fn(*ops)):.4f}" if label == "ceiling" else ""
            log(f"kernel {name} {label} B={B} T={T} S={S}: max|d|={err:.3g} "
                f"bit_identical={same:.6f} neg_inf_share={neg.float().mean().item():.4f}{timed}")
    c = cases["path"]
    B, T, S = c["emit"].shape
    nll = tctc._nll_of(cl.ctc_alpha(c["emit"], c["lens"], c["skip"], c["alpha0"])[:, -1],
                       c["label_lens"])
    lp = torch.log_softmax(c["logits"], -1).transpose(0, 1).contiguous()  # [T, B, V]

    def library(backward):
        x = lp.detach().requires_grad_(backward)
        loss = F.ctc_loss(x, c["labels"], c["lens"], c["label_lens"], blank=3,
                          reduction="none")
        if backward:
            loss.sum().backward()
        return loss

    lib_nll = library(False)
    ok = torch.isfinite(lib_nll) & (nll < -0.5 * cl.NEG_INF)
    nll_err = ((nll - lib_nll).abs() / lib_nll.abs())[ok].max().item()
    if nll_err > 1e-4:
        raise AssertionError(f"ctc NLL differs from F.ctc_loss by {nll_err} relative")
    t_bytes, t_ops = _lattice_bound(c)
    lib_ms = {"ctc_alpha": cuda_ms(lambda: library(False)),
              "ctc_beta": cuda_ms(lambda: library(True))}
    for name, fn, plain, init in (("ctc_alpha", cl.ctc_alpha, cl.ctc_alpha_reference, "alpha0"),
                                  ("ctc_beta", cl.ctc_beta, cl.ctc_beta_reference, "beta0")):
        ops = (c["emit"], c["lens"], c["skip"], c[init])
        ms = cuda_ms(lambda: fn(*ops))
        plain_ms = cuda_ms(lambda: plain(*ops), iters=3, warmup=1)
        log(f"kernel {name} path B={B} T={T} S={S}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={max(t_bytes, t_ops):.5f} (bytes {t_bytes:.5f}, f32 {t_ops:.6f}; "
            f"the recursion is {T - 1} dependent steps: {ms / (T - 1) * 1e3:.3f} us a step) "
            f"library_ms={lib_ms[name]:.4f} (F.ctc_loss {'forward' if name == 'ctc_alpha' else 'forward + backward'})")
        rows[name] = {
            "name": name,
            "route": "cuda",
            "source": "onebit_asr_tpu_torch/csrc/ctc_lattice.cu",
            "replaces": ("onebit_asr_tpu/ops/ctc_pallas.py:97" if name == "ctc_alpha"
                         else "onebit_asr_tpu/ops/ctc_pallas.py:117"),
            "launches": 0,
            "max_abs_err": errs[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms[name],
        }
    cudnn = torch.backends.cudnn.enabled and torch.backends.cudnn.is_available()
    log(f"library: F.ctc_loss with blank 3 ran PyTorch's native CUDA kernel (cuDNN "
        f"{'available' if cudnn else 'absent'}; its CTC needs blank 0); per-utterance NLL "
        f"of the port's lattice vs F.ctc_loss: max relative |d| {nll_err:.3g} over "
        f"{int(ok.sum())} feasible rows")


def _lattice_bound(c):
    """(bytes ms, f32 ms) of one lattice launch on case `c`: it reads the
    emission rows the lengths need (rows 1 .. len-1), the init row, the mask
    and the lengths, and writes the lattice; 10 f32 operations (3 exp, 1
    log, 6 add/max) a state and recursive step."""
    B, T, S = c["emit"].shape
    steps = int((c["lens"].clamp(1, T) - 1).sum())
    nbytes = (steps * S * 4 + B * T * S * 4 + B * S * (4 + c["skip"].element_size())
              + B * c["lens"].element_size())
    return nbytes / HBM_BYTES_PER_S * 1e3, 10.0 * steps * S / PEAK_OPS["f32"] * 1e3


def _lattice_case_inits(c):
    """The alpha and beta init rows of a case (again after its lengths were
    edited)."""
    from onebit_asr_tpu_torch.losses import ctc as tctc
    from onebit_asr_tpu_torch.ops.ctc_lattice import NEG_INF

    s_idx = torch.arange(c["emit"].shape[2], device=c["emit"].device)[None]
    ll = c["label_lens"][:, None]
    beta0 = torch.where((s_idx == 2 * ll) | ((s_idx == 2 * ll - 1) & (ll > 0)), 0.0,
                        NEG_INF).float()
    return {"alpha0": tctc._alpha0_of(c["emit"], c["label_lens"]), "beta0": beta0}


# kernel-name keys of the lattice launches (csrc/ctc_lattice.cu) and of
# F.ctc_loss's own lattice kernels (PyTorch's native CUDA CTC)
CTC_KERNELS = {"ctc_alpha": "ctc_alpha_kernel", "ctc_beta": "ctc_beta_kernel"}
LIBRARY_CTC_KERNELS = {"ctc_alpha": "ctc_loss_log_alpha_gpu_kernel",
                       "ctc_beta": "ctc_loss_backward_log_beta_gpu_kernel"}


def ctc_device_phase(seed, rows):
    """Device time per launch (torch.profiler) of rows 7 and 8 at the train
    step's shape and at LibriSpeech's ceiling, on the loss's operands; each
    wrapper call must run exactly its one kernel, within [0.7, 1.1] x the
    queued events' time (`checked_device_ms`). Beside each: F.ctc_loss's
    own lattice kernel on the same lattice, picked by name from a profile of
    its forward (alpha) or forward + backward (beta). Adds device_ms,
    queued_ms, step_us, library_device_ms, library_kernel, bound_share, the
    variant and the same at the ceiling (`ceiling`) to the rows. Run after
    every timed phase, as kernel_device_phase."""
    import torch.nn.functional as F

    from onebit_asr_tpu_torch.ops import ctc_lattice as cl

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed)  # the path and ceiling cases of ctc_kernel_phase
    for label, args in (("path", (48, 256, 48, 5004, 255)), ("ceiling", (16, 512, 228, 5004, 400))):
        c = _lattice_case(rng, *args, dev)
        B, T, S = c["emit"].shape
        plan = cl.launch_plan(S)
        t_bytes, t_ops = _lattice_bound(c)
        bound = max(t_bytes, t_ops)
        lp = torch.log_softmax(c["logits"], -1).transpose(0, 1).contiguous()  # [T, B, V]

        def library(backward):
            x = lp.detach().requires_grad_(backward)
            loss = F.ctc_loss(x, c["labels"], c["lens"], c["label_lens"], blank=3,
                              reduction="none")
            if backward:
                loss.sum().backward()

        lib_per = {"ctc_alpha": device_ms(lambda: library(False), iters=10, per_kernel=True)[1],
                   "ctc_beta": device_ms(lambda: library(True), iters=10, per_kernel=True)[1]}
        for name, fn, init in (("ctc_alpha", cl.ctc_alpha, "alpha0"),
                               ("ctc_beta", cl.ctc_beta, "beta0")):
            ops = (c["emit"], c["lens"], c["skip"], c[init])
            ms, _, q_ms = checked_device_ms(f"{name} {label}", lambda: fn(*ops),
                                            (CTC_KERNELS[name],))
            lib_names = [k for k in lib_per[name] if LIBRARY_CTC_KERNELS[name] in k]
            lib_ms = lib_per[name][lib_names[0]] if len(lib_names) == 1 else None
            lib_name = None  # its name from the kernel's own on, without the arguments
            if len(lib_names) == 1:
                tail = lib_names[0][lib_names[0].index(LIBRARY_CTC_KERNELS[name]):]
                lib_name = tail.split(">(")[0] + ">" if ">(" in tail else tail.split("(")[0]
            entry = {"device_ms": ms, "queued_ms": q_ms, "step_us": ms / (T - 1) * 1e3,
                     "bound_ms": bound, "bound_share": bound / ms,
                     "library_device_ms": lib_ms, "library_kernel": lib_name,
                     "states_per_lane": plan["states_per_lane"], "warps": plan["warps"],
                     "smem_bytes": plan["smem"]}
            log(f"kernel device {name} {label} B={B} T={T} S={S}: device_ms={ms:.5f} per launch "
                f"(queued events {q_ms:.5f}; {ms / (T - 1) * 1e3:.4f} us a step over {T - 1} "
                f"steps) bound_ms={bound:.5f} (bytes {t_bytes:.5f}, f32 {t_ops:.6f}) "
                f"bound_share={bound / ms:.4f} library_device_ms="
                + (f"{lib_ms:.5f} ({lib_name})" if lib_ms is not None else
                   f"none (no single {LIBRARY_CTC_KERNELS[name]} among "
                   f"{[k[:60] for k in lib_per[name]]})")
                + f" variant: {plan['states_per_lane']} states a lane, {plan['warps']} warps an "
                f"utterance, {plan['smem']} B shared")
            if label == "path":
                rows[name].update(entry)
            else:
                rows[name]["ceiling"] = {"B": B, "T": T, "S": S, **entry}


@contextlib.contextmanager
def plain_ctc():
    """The CTC loss on the lattices' plain versions for the duration."""
    from onebit_asr_tpu_torch.losses import ctc as tctc
    from onebit_asr_tpu_torch.ops import ctc_lattice as cl

    tctc.ctc_alpha, tctc.ctc_beta = cl.ctc_alpha_reference, cl.ctc_beta_reference
    try:
        yield
    finally:
        tctc.ctc_alpha, tctc.ctc_beta = cl.ctc_alpha, cl.ctc_beta


def bench_batch(cfg, seed):
    """bench.py's batch of record: B=16, 1,024 frames of random features,
    U=48 random tokens; lengths from half to full."""
    from onebit_asr_tpu_torch.train.step import batch_to_device

    rng = np.random.default_rng(seed)
    B, T, U = 16, 1024, 48
    return batch_to_device({
        "feats": rng.standard_normal((B, T, cfg.input_dim)).astype(np.float32),
        "feat_lens": rng.integers(T // 2, T + 1, size=B),
        "tokens": rng.integers(4, cfg.vocab_size, size=(B, U)),
        "token_lens": rng.integers(U // 2, U + 1, size=B),
    }, DEVICE)


@contextlib.contextmanager
def swapped_attention(model, attention_fn=None, fused=True):
    """Every RelPosMHSA of `model` with `attention_fn` (if given) and
    `fused` for the duration."""
    from onebit_asr_tpu_torch.model.conformer import RelPosMHSA

    mods = [m for m in model.modules() if isinstance(m, RelPosMHSA)]
    saved = [(m.attention_fn, m.fused) for m in mods]
    for m in mods:
        m.attention_fn = attention_fn or m.attention_fn
        m.fused = fused
    try:
        yield
    finally:
        for m, (fn, was_fused) in zip(mods, saved):
            m.attention_fn, m.fused = fn, was_fused


@contextlib.contextmanager
def swapped_subsample(model, subsample_fn):
    """The encoder's subsampler with `subsample_fn` for the duration."""
    sub = model.encoder.subsample
    saved = sub.subsample_fn
    sub.subsample_fn = subsample_fn
    try:
        yield
    finally:
        sub.subsample_fn = saved


def _grads_cmp(grads, ref):
    """(|grads - ref| / |ref|, cosine) over all gradients together."""
    num = sum(float(((grads[k].float() - ref[k].float()) ** 2).sum()) for k in ref)
    dot = sum(float((grads[k].float() * ref[k].float()).sum()) for k in ref)
    n2 = sum(float((grads[k].float() ** 2).sum()) for k in ref)
    den = sum(float((ref[k].float() ** 2).sum()) for k in ref)
    return (num / den) ** 0.5, dot / (n2 * den) ** 0.5


def train_step_phase(cfg, seed, rows, kernels):
    """The library train step at full width on the kernels, its launches per
    step, and one step against the same step with the plain lattices or,
    under fused_attention, the plain attention (and loosely the unfused
    chain) or, under fused_subsampler, the plain subsampler Function (and
    loosely the unfused conv pair). Returns what to profile of it, as
    [(what, fn, top)], for the caller to run after every timed phase: a
    finished profiler run can slow later host code."""
    from onebit_asr_tpu_torch.ops import attention as fa
    from onebit_asr_tpu_torch.ops import subsampler as ss
    from onebit_asr_tpu_torch.convert import init_params, qat_model_from_jax
    from onebit_asr_tpu_torch.train import AdamW, create_train_state, make_train_step
    from onebit_asr_tpu_torch.train.state import param_count
    from onebit_asr_tpu_torch.train.step import make_batch_loss, sample_sp_mask, value_and_grad
    from onebit_asr_tpu_torch.utils.config import LossConfig, OptimConfig, SpecialTokens

    # what earlier phases still hold (a train phase's state, kept for its
    # profile) is not this phase's memory
    base = torch.cuda.memory_allocated()
    model = qat_model_from_jax(cfg, init_params(cfg, seed), device=DEVICE)
    state = create_train_state(model, seed)
    loss_cfg, specials = LossConfig(), SpecialTokens()
    optimizer = AdamW(OptimConfig(), 100_000)
    step = make_train_step(model, optimizer, loss_cfg, specials, cfg.enc_layers)
    batch = bench_batch(cfg, seed)
    state, aux = step(state, batch)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset(kernels)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    auxes = []
    start.record()
    for _ in range(TRAIN_STEPS):
        state, aux = step(state, batch)
        auxes.append(aux)
    end.record()
    torch.cuda.synchronize()
    counts = _counts(kernels)
    fused = cfg.fused_attention
    label = ("train step fused_attention" if fused else
             "train step fused_subsampler" if cfg.fused_subsampler else "train step")
    per_step = {"ctc_alpha": 1, "ctc_beta": 1}
    if fused:  # each block of each of the three branches
        per_step.update(fused_relpos_attention=3 * cfg.enc_layers,
                        fused_relpos_attention_bwd=3 * cfg.enc_layers)
    if cfg.fused_subsampler:  # each of the three branches
        per_step.update(fused_subsample=3, fused_subsample_bwd=3)
    want = {k: TRAIN_STEPS * n for k, n in per_step.items()}
    if counts != want:
        raise AssertionError(f"{label}: launches {counts}, want {want}")
    for k in (("fused_relpos_attention_bwd",) if fused else
              ("fused_subsample_bwd",) if cfg.fused_subsampler else ("ctc_alpha", "ctc_beta")):
        rows[k]["launches"] = counts[k]
    ms = start.elapsed_time(end) / TRAIN_STEPS
    STEP_MS[label] = ms
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    losses = [{k: float(v) for k, v in a.items()} for a in auxes]
    if not all(np.isfinite(list(l.values())).all() for l in losses):
        raise AssertionError(f"{label}: non-finite loss or grad_norm {losses}")
    log(f"{label}: Conformer-M {param_count(state.params) / 1e6:.2f}M params, B=16, T=1024 "
        f"(T'=256), U<=48, dropout {cfg.dropout}, {cfg.compute_dtype}: ms_per_step={ms:.2f} "
        f"peak_mem_gb={peak_gb:.3f} launches_per_step="
        f"{ {k: v // TRAIN_STEPS for k, v in counts.items() if v} } steps={state.step}")
    for i, l in enumerate(losses):
        log(f"{label} {i}: " + " ".join(f"{k}={v:.5g}" for k, v in l.items()))

    # one step's loss and gradients on the kernels and on the plain versions,
    # from the same state, mask and dropout seeds
    batch_loss = make_batch_loss(model, loss_cfg, specials, cfg.enc_layers)
    g = torch.Generator()
    g.manual_seed(seed + 1)
    sp = sample_sp_mask(g, cfg.enc_layers)

    def run():
        gens = [torch.Generator(device=DEVICE).manual_seed(seed + i) for i in range(3)]
        return value_and_grad(batch_loss, state.params, batch, sp, gens)

    (_, aux_k), grads_k = run()
    if fused:
        plain, aux_tol, grad_tol = "plain attention", 1e-2, 0.1
        with swapped_attention(model, fa.fused_relpos_attention_plain):
            (_, aux_p), grads_p = run()
    elif cfg.fused_subsampler:
        plain, aux_tol, grad_tol = "plain subsampler", 1e-2, 0.1
        with swapped_subsample(model, ss.fused_subsample_plain):
            (_, aux_p), grads_p = run()
    else:
        plain, aux_tol, grad_tol = "plain CTC", 1e-4, 1e-2
        with plain_ctc():
            (_, aux_p), grads_p = run()
    torch.cuda.synchronize()
    aux_err = max(abs(float(aux_k[k]) - float(aux_p[k])) / abs(float(aux_p[k])) for k in aux_p)
    grad_err, _ = _grads_cmp(grads_k, grads_p)
    log(f"{label} kernels vs {plain}: aux max relative |d|={aux_err:.3g} (tolerance "
        f"{aux_tol}) grads |d|/|g|={grad_err:.3g} (tolerance {grad_tol}) "
        f"loss_ctc_2bit={float(aux_k['loss_ctc_2bit']):.6g}/{float(aux_p['loss_ctc_2bit']):.6g}")
    if aux_err > aux_tol or grad_err > grad_tol:
        raise AssertionError(f"{label} on the kernels strays from the {plain}")
    if fused or cfg.fused_subsampler:
        # the unfused chain on the same draws rounds the scores to bf16; the
        # unfused conv pair rounds the features and conv1 to bf16
        what = "the unfused chain" if fused else "the unfused conv pair"
        with (swapped_attention(model, fused=False) if fused else
              swapped_subsample(model, unfused_subsample)):
            (_, aux_u), grads_u = run()
        diff, cos = _grads_cmp(grads_k, grads_u)
        log(f"{label} kernels vs {what}: loss {float(aux_k['loss']):.6g}/"
            f"{float(aux_u['loss']):.6g} grads |d|/|g|={diff:.3g} cosine={cos:.5f} "
            f"(tolerance >= 0.95)")
        if cos < 0.95:
            raise AssertionError(f"{label}: gradients far from {what}'s")
        del grads_u
    del grads_p
    return [(f"one {label}", lambda: step(state, batch), 15),
            (f"the loss and gradients of one {label} (value_and_grad)", run, 5),
            (f"the optimizer update of one {label} (clip + AdamW over every parameter)",
             lambda: optimizer.update(state.params, grads_k, state.mu, state.nu, state.count),
             5)]


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


DP_STEPS = 3
# step 20's limits on a parallel path's distance to the one-process step:
# loss and aux terms, max relative |d|; grad_norm, max relative |d|;
# parameters, |p - p_ref| / |p_ref - p_0| over all leaves (0 when equal, 1
# for a step that leaves them where they were); moments, |d| / |ref| over
# all leaves. Set from the card's run-to-run spread of the one-process step,
# whose largest readings in 13 runs (scripts/dp_probe.py and this step; the
# parallel paths fell on the same outcomes) were 1.16e-3, 2.66e-3, 1.88e-2
# and 5.29e-3 (grad_norm 6.54e-3 and moments 9.44e-3 at an LR below 4e-7):
# each limit is 3-5x that, the parameters' a tenth of a step that does not
# move them
DP_TOL = (5e-3, 3e-2, 0.1, 3e-2)


def dp_setup(seed, **flags):
    """Step 20's model config (Conformer-M, both fused flags, dropout 0; with
    `flags` over it), its random parameters from `seed`, and bench.py's
    batch."""
    from onebit_asr_tpu_torch.convert import init_params
    from onebit_asr_tpu_torch.utils.config import ModelConfig

    cfg = dataclasses.replace(ModelConfig(), **{"dropout": 0.0, "fused_attention": True,
                                                "fused_subsampler": True, **flags})
    return cfg, init_params(cfg, seed), bench_batch(cfg, seed)


@contextlib.contextmanager
def nccl_world_of_one():
    """An nccl process group of this process alone (MASTER_ADDR=127.0.0.1,
    a free port), and the mesh over it."""
    import torch.distributed as dist

    from onebit_asr_tpu_torch.parallel.mesh import make_mesh

    saved_env = {k: os.environ.get(k) for k in ("MASTER_ADDR", "MASTER_PORT")}
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    dist.init_process_group("nccl", rank=0, world_size=1, device_id=torch.device(DEVICE, 0))
    try:
        mesh = make_mesh()
        if mesh.group is None or mesh.size != 1:
            raise AssertionError(f"data parallel: mesh {mesh}")
        yield mesh
    finally:
        dist.destroy_process_group()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def dp_step(kind, cfg, params, mesh, seed):
    """A fresh state from `params` and the step of `kind` ("one process",
    "data parallel" or "zero-2") over `mesh`, with AdamW at a one-step
    warm-up (the LR is 0 at step 0 and full from step 1 on): (step, state,
    the full layout's dims or None). Under zero-2 the state is this rank's
    shard and the model keeps no weights, as in the CLI."""
    from onebit_asr_tpu_torch.convert import qat_model_from_jax
    from onebit_asr_tpu_torch.parallel.fsdp import (
        make_fsdp_train_step,
        shard_dims,
        shard_state_fsdp,
    )
    from onebit_asr_tpu_torch.train import AdamW, create_train_state, make_train_step
    from onebit_asr_tpu_torch.train.step import make_sharded_train_step
    from onebit_asr_tpu_torch.utils.config import LossConfig, OptimConfig, SpecialTokens

    model = qat_model_from_jax(cfg, params, device=DEVICE)
    state = create_train_state(model, seed)
    optimizer = AdamW(OptimConfig(warmup_steps=1), 100_000)
    args = (model, optimizer, LossConfig(), SpecialTokens(), cfg.enc_layers)
    if kind == "one process":
        return make_train_step(*args), state, None
    if kind == "data parallel":
        return make_sharded_train_step(*args, mesh), state, None
    step = make_fsdp_train_step(*args, mesh, state)
    dims = shard_dims(state.params, mesh.size)
    state = shard_state_fsdp(state, mesh)
    for p in model.parameters():  # as the CLI does: the step passes params in
        p.data = p.data.new_empty(0)
    return step, state, dims


def dp_run(kind, cfg, params, batch, mesh, kernels, seed, steps=DP_STEPS, warmup=True):
    """1 + DP_STEPS steps of `kind` (`dp_step`) on `batch`: each step's aux,
    the launches and the ms per step (CUDA events) of the last DP_STEPS, the
    peak memory over them, the parameters before the first step (None
    under zero-2) and the full parameters and moments after the last, on
    the host."""
    from onebit_asr_tpu_torch.parallel.fsdp import gather_state_fsdp
    from onebit_asr_tpu_torch.parallel.mesh import shard_batch

    base = torch.cuda.memory_allocated()
    step, state, dims = dp_step(kind, cfg, params, mesh, seed)
    start_params = (None if dims is not None else
                    {k: v.detach().to("cpu", copy=True) for k, v in state.params.items()})
    state, run = timed_steps_run(step, state, shard_batch(batch, mesh), kernels, base, steps,
                                 warmup)
    if dims is not None:
        state = gather_state_fsdp(state, mesh, dims)
    run.update(start=start_params, **{part: {k: v.detach().cpu() for k, v in
                                             getattr(state, part).items()}
                                      for part in ("params", "mu", "nu")})
    del step, state
    torch.cuda.empty_cache()
    return run


def timed_steps_run(step, state, batch, kernels, base, steps=DP_STEPS, warmup=True):
    """A warm-up step (with `warmup`), then `steps` steps of `step` on
    `batch`: (state, {aux of each step, the launches and the ms per step
    (CUDA events) of the last `steps`, the peak memory over them above
    `base`})."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    auxes = []
    if warmup:
        state, aux = step(state, batch)
        auxes.append(aux)
    _reset(kernels)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        state, aux = step(state, batch)
        auxes.append(aux)
    end.record()
    torch.cuda.synchronize()
    return state, dict(aux=[{k: float(v) for k, v in a.items()} for a in auxes],
                       counts=_counts(kernels), ms=start.elapsed_time(end) / steps,
                       peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9)


def dp_distance(run, ref):
    """`run`'s distances to `ref` in DP_TOL's order, whether it is
    bit-equal, and a line of them beside max |d| of each part."""
    pairs = list(zip(run["aux"], ref["aux"]))
    d_aux = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in pairs for k in b
                if k != "grad_norm" and b[k])
    d_norm = max(abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"] for a, b in pairs)

    def norm(tensors):
        return sum(float(t.double().square().sum()) for t in tensors) ** 0.5

    update = norm(v - ref["start"][k] for k, v in ref["params"].items())
    d_params = norm(run["params"][k] - v for k, v in ref["params"].items()) / update
    d_mom = max(norm(run[part][k] - v for k, v in ref[part].items()) / norm(ref[part].values())
                for part in ("mu", "nu"))
    bit_equal = run["aux"] == ref["aux"] and all(
        torch.equal(run[part][k], v) for part in ("params", "mu", "nu")
        for k, v in ref[part].items())
    abs_d = {"loss": max(abs(a["loss"] - b["loss"]) for a, b in pairs),
             "grad_norm": max(abs(a["grad_norm"] - b["grad_norm"]) for a, b in pairs),
             **{part: max(float((run[part][k] - v).abs().max())
                          for k, v in ref[part].items()) for part in ("params", "mu", "nu")}}
    text = (f"max |d| {' '.join(f'{k}={v:.3g}' for k, v in abs_d.items())}; loss/aux max "
            f"relative |d|={d_aux:.3g} grad_norm {d_norm:.3g} params |d|/|update| "
            f"{d_params:.3g} (|update|={update:.4g}) moments |d|/|ref| {d_mom:.3g} "
            f"bit_equal={bit_equal} losses={[round(a['loss'], 6) for a in run['aux']]}")
    return (d_aux, d_norm, d_params, d_mom), bit_equal, text


def data_parallel_phase(kernels, seed, smi):
    """Step 20: the data-parallel and ZeRO-2 steps over an nccl world of 1
    against the one-process step, then the train CLI under torchrun with
    --fsdp and its --resume. Returns the one-process step's run."""
    t_phase = time.perf_counter()
    cfg, params, batch = dp_setup(seed)
    with nccl_world_of_one() as mesh:
        runs = {kind: dp_run(kind.replace(" again", ""), cfg, params, batch, mesh, kernels,
                             seed)
                for kind in ("one process", "one process again", "data parallel", "zero-2")}
    ref = runs["one process"]
    per_step = {"ctc_alpha": 1, "ctc_beta": 1, "fused_relpos_attention": 3 * cfg.enc_layers,
                "fused_relpos_attention_bwd": 3 * cfg.enc_layers, "fused_subsample": 3,
                "fused_subsample_bwd": 3}
    want = {k: DP_STEPS * n for k, n in per_step.items()}
    log(f"data parallel: one process: Conformer-M both fused flags, dropout 0, B=16, T=1024, "
        f"U<=48: ms_per_step={ref['ms']:.2f} peak_mem_gb={ref['peak_gb']:.3f} "
        f"launches={ref['counts']} [{smi}]")
    if ref["counts"] != want:
        raise AssertionError(f"data parallel: one-process launches {ref['counts']}, want {want}")
    _, _, text = dp_distance(runs["one process again"], ref)
    log(f"data parallel: one process vs itself (run to run): {text}")
    for kind in ("data parallel", "zero-2"):
        run = runs[kind]
        dist_, _, text = dp_distance(run, ref)
        log(f"data parallel: {kind} (nccl, world 1): ms_per_step={run['ms']:.2f} "
            f"peak_mem_gb={run['peak_gb']:.3f} launches={run['counts']} vs one process: {text}")
        if run["counts"] != ref["counts"]:
            raise AssertionError(f"data parallel: {kind} launches {run['counts']}, "
                                 f"one process {ref['counts']}")
        if any(d > t for d, t in zip(dist_, DP_TOL)):
            raise AssertionError(f"data parallel: {kind} strays from the one-process step: "
                                 f"{dist_} beyond {DP_TOL}")
    del runs

    # the CLI under torchrun: --fsdp for 2 epochs, then --resume to a third
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "onebit_asr_tpu_torch",
                                                      "_build")) as root:
        argv = ["--fsdp", "--dummy_data", "--steps_per_epoch", "2", "--batch_size", "4",
                "--eval_batches", "1", "--dummy_frames", "160", "--enc_layers", "2",
                "--enc_d_model", "64", "--enc_heads", "2", "--enc_d_ff", "128",
                "--enc_conv_kernel", "7", "--dec_layers", "1", "--dec_d_ff", "64",
                "--save_dir", root, "--run_name", "fsdp", "--device", DEVICE]
        for epochs, extra in ((2, []), (3, ["--resume"])):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc_per_node", "1", "-m", "onebit_asr_tpu_torch.train", *argv,
                 "--epochs", str(epochs), *extra],
                cwd=REPO, env={**os.environ, "PYTHONPATH": REPO}, capture_output=True, text=True,
                timeout=300)
            for line in proc.stdout.splitlines():
                log(f"torchrun --fsdp{' --resume' if extra else ''}: {line}")
            if proc.returncode != 0:
                raise AssertionError(f"torchrun --fsdp {' '.join(extra)}: rc={proc.returncode} "
                                     f"{proc.stderr[-2000:]}")
            ckpt = os.path.join(root, "fsdp", "ckpt", f"step_{2 * epochs}.pt")
            if not os.path.exists(ckpt) or (extra and "resumed at step 4 (epoch 2)"
                                            not in proc.stdout):
                raise AssertionError(f"torchrun --fsdp {' '.join(extra)}: no {ckpt} or no resume")
            log(f"torchrun --fsdp{' --resume' if extra else ''}: rc=0 wall_s="
                f"{time.perf_counter() - t0:.2f} ({epochs} epochs, step_{2 * epochs}.pt)")
    log(f"data parallel: step 20 in {time.perf_counter() - t_phase:.2f} s")
    return ref


TP_SIZE = 2  # step 21's model axis: two ranks on one card
# step 21's limits on the TP step's distance to the one-process step, in
# DP_TOL's order: DP_TOL's, but loss and aux terms 1.5e-2. The TP step sums
# each row-parallel product's halves in another f32 order, so its bf16
# activations round apart from the one-process step's even on identical
# parameters (on the CPU at bf16, d=256: the KL terms 1.1e-3 relative at
# the first step), and the 3 updates grow that: three runs on the card read
# 4.03e-3, 4.08e-3 and 5.21e-3, each in a KL term (0.05-0.13), against
# 9.32e-4 for the one-process step against itself (PERF.md §6, tensor parallelism); the
# limit is 3x the largest, as DP_TOL's are 3-5x the readings they came from
TP_TOL = (1.5e-2,) + DP_TOL[1:]


def smoke_kernels():
    """{name: wrapper} of the eight kernel rows, whose `launches` the
    phases read."""
    from onebit_asr_tpu_torch.ops import attention as fa
    from onebit_asr_tpu_torch.ops import ctc_lattice as cl
    from onebit_asr_tpu_torch.ops import subsampler as ss
    from onebit_asr_tpu_torch.ops import ternary_matmul as tm

    return {"ternary_matmul_bf16": tm.ternary_matmul,
            "ternary_matmul_w2a8": tm.ternary_matmul_w2a8,
            "fused_subsample": ss.fused_subsample,
            "fused_subsample_bwd": ss.fused_subsample_bwd,
            "fused_relpos_attention": fa.fused_relpos_attention,
            "fused_relpos_attention_bwd": fa.fused_relpos_attention_bwd,
            "ctc_alpha": cl.ctc_alpha, "ctc_beta": cl.ctc_beta}


def _digest(state):
    """A hash of every tensor of a TrainState's params, mu and nu, in order."""
    import hashlib

    h = hashlib.sha256()
    for part in ("params", "mu", "nu"):
        for k, v in getattr(state, part).items():
            h.update(k.encode())
            h.update(v.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def attention_shapes(dim):
    """Record dim `dim` of q (1: heads, 0: rows) at every launch of rows 3
    and 4: {row: set of sizes}, which the caller clears."""
    from onebit_asr_tpu_torch.ops import attention as fa

    seen = {"fused_relpos_attention": set(), "fused_relpos_attention_bwd": set()}

    def recorded(name, fn):
        def call(q, *args, **kwargs):
            seen[name].add(int(q.shape[dim]))
            return fn(q, *args, **kwargs)
        return call

    fa._KERNELS = (recorded("fused_relpos_attention", fa._KERNELS[0]),
                   recorded("fused_relpos_attention_bwd", fa._KERNELS[1]))
    return seen


def tp_rank_work(seed):
    """One rank of step 21: the TP step at dropout 0 (a warm-up + DP_STEPS
    steps) and at 0.1 (one step from a fresh state), each with the rows 3-4
    launches' head counts; rank 0 also returns the gathered state of the
    first."""
    import torch.distributed as dist

    from onebit_asr_tpu_torch.convert import qat_model_from_jax
    from onebit_asr_tpu_torch.parallel.mesh import make_mesh
    from onebit_asr_tpu_torch.parallel.sharding_rules import gather_state_tp, shard_state_tp
    from onebit_asr_tpu_torch.train import AdamW, create_train_state, make_tp_train_step
    from onebit_asr_tpu_torch.utils.config import LossConfig, OptimConfig, SpecialTokens

    kernels = smoke_kernels()
    heads = attention_shapes(1)
    mesh = make_mesh((1, TP_SIZE), ("data", "model"))
    cfg, params, batch = dp_setup(seed)
    out = {"coords": mesh.coords}
    for dropout in (0.0, 0.1):
        c = dataclasses.replace(cfg, dropout=dropout)
        model = qat_model_from_jax(c, params, device=DEVICE)
        state = create_train_state(model, seed)
        optimizer = AdamW(OptimConfig(warmup_steps=1), 100_000)
        step = make_tp_train_step(model, optimizer, LossConfig(), SpecialTokens(), c.enc_layers,
                                  mesh)
        state = shard_state_tp(state, mesh)
        for p in model.parameters():  # as the CLI does: the step passes params in
            p.data = p.data.new_empty(0)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        for h in heads.values():
            h.clear()
        state, run = timed_steps_run(step, state, batch, kernels, base,
                                     *((DP_STEPS, True) if dropout == 0 else (1, False)))
        run["heads"] = {k: sorted(v) for k, v in heads.items()}
        full = gather_state_tp(state, mesh)
        run["digest"] = _digest(full)
        if dist.get_rank() == 0:  # numpy: a tensor crosses the queue as a handle
            run.update({part: {k: v.detach().cpu().numpy() for k, v in
                               getattr(full, part).items()} for part in ("params", "mu", "nu")})
        out[dropout] = run
        del model, state, full, step
        torch.cuda.empty_cache()
    return out


def rank_main(work, rank, world, port, seed, outbox):
    """Rank `rank` of `world` on cuda:0, in a gloo group at
    127.0.0.1:`port`: `work(seed)`'s results, or its traceback, into
    `outbox`."""
    import traceback

    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world)
        try:
            outbox.put((rank, True, work(seed)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        outbox.put((rank, False, traceback.format_exc()))
        raise


def spawn_ranks(work, world, seed, what, timeout=900):
    """`world` ranks, each a spawned process on cuda:0 running `work(seed)`
    (steps 21 and 22; gloo sums CUDA tensors through the host, nccl takes
    one rank a device): their results in rank order; raises with a rank's
    traceback if one failed, and soon if one died without a word."""
    import multiprocessing as mp
    import queue

    ctx = mp.get_context("spawn")
    outbox = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=rank_main, args=(work, r, world, port, seed, outbox))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    got = []
    try:
        while len(got) < len(procs):
            try:
                got.append(outbox.get(timeout=5))
                continue
            except queue.Empty:
                pass
            done = {r for r, _, _ in got}
            dead = {r: p.exitcode for r, p in enumerate(procs)
                    if r not in done and p.exitcode is not None}
            if dead:  # a rank that died without a word: one last look, then fail
                try:
                    got.append(outbox.get(timeout=10))
                    continue
                except queue.Empty:
                    raise AssertionError(f"{what}: ranks {dead} (rank: exit code) "
                                         "ended without a result") from None
            if time.monotonic() > deadline:
                raise AssertionError(f"{what}: no result in {timeout} s")
        got.sort(key=lambda r: r[0])
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    for rank, ok, value in got:
        if not ok:
            raise AssertionError(f"{what}: rank {rank} failed:\n{value}")
    return [value for _, _, value in got]


def as_tensors(run):
    """A rank's run with its params, mu and nu as tensors again."""
    return {**run, **{part: {k: torch.from_numpy(v) for k, v in run[part].items()}
                      for part in ("params", "mu", "nu")}}


def _heads_slice(t, h0, h1, dim=1):
    return t.narrow(dim, h0, h1 - h0).contiguous()


def attention_parts_check(cfg, seed, dim, parts):
    """Rows 3 and 4 (training form) at the train step's shape [16, H, 256,
    64], dropout 0.1, split in `parts` along q's dim `dim` (1: a TP rank's
    heads, step 21; 0: a pipeline microbatch's rows, step 22): each part
    against the plain versions and against the same part of one launch on
    the whole. Returns (max |d| to the plain versions, max |d| to the whole
    launch's part, whether that part is bit-equal). Over rows, dp, du and
    dvb sum over the batch: the parts' sum is held against the whole's
    (max |d| only)."""
    from onebit_asr_tpu_torch.ops import attention as fa

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed + 21)
    B, H, T, dh, rate = 16, cfg.enc_heads, 256, cfg.enc_d_model // cfg.enc_heads, 0.1
    lens = np.concatenate([[255], rng.integers(128, 256, B - 1)])
    key_mask = torch.from_numpy(
        (np.arange(T)[None] < lens[:, None]).astype(np.float32)).to(dev)
    q, k, v, g = (rng.standard_normal((B, H, T, dh)) for _ in range(4))
    p = rng.standard_normal((H, 2 * T - 1, dh))
    u, vb = (0.1 * rng.standard_normal((H, dh)) for _ in range(2))
    q, k, v, g, p, u, vb = (torch.from_numpy(a.astype(np.float32)).to(dev).to(torch.bfloat16)
                            for a in (q, k, v, g, p, u, vb))
    g = g * key_mask[:, None, :, None].to(g.dtype)
    drop8 = torch.from_numpy(rng.integers(0, 256, size=(B, H, T, T), dtype=np.uint8)).to(dev)
    scale = 1.0 / float(np.sqrt(dh))
    full_out, full_stats = fa._fwd(q, k, v, p, u, vb, key_mask, drop8, scale, rate, stats=True)
    full_grads = fa.fused_relpos_attention_bwd(q, k, v, p, u, vb, key_mask, drop8, g, scale,
                                               rate, stats=full_stats)
    err_plain = err_full = 0.0
    bit_equal = True
    n = (H if dim == 1 else B) // parts
    summed = [torch.zeros_like(t, dtype=torch.float32) for t in full_grads[3:]]
    for h0 in range(0, n * parts, n):
        h1 = h0 + n
        if dim == 1:  # heads: p, u and vb split too, the key mask whole
            ops = (*(_heads_slice(t, h0, h1) for t in (q, k, v)),
                   *(_heads_slice(t, h0, h1, 0) for t in (p, u, vb)), key_mask,
                   _heads_slice(drop8, h0, h1))
        else:  # rows: the key mask and the draws split, p, u and vb whole
            ops = (*(_heads_slice(t, h0, h1, 0) for t in (q, k, v)), p, u, vb,
                   _heads_slice(key_mask, h0, h1, 0), _heads_slice(drop8, h0, h1, 0))
        gl = _heads_slice(g, h0, h1, dim)
        out, stats = fa._fwd(*ops, scale, rate, stats=True)
        grads = fa.fused_relpos_attention_bwd(*ops, gl, scale, rate, stats=stats)
        ref = fa.fused_relpos_attention_reference(*ops, scale, rate).float()
        d = (out.float() - ref).abs()
        if not bool((d <= 1e-2 + 2.0 ** -7 * ref.abs()).all()):
            raise AssertionError(f"row 3 on part {h0}:{h1} of dim {dim}: max |d| "
                                 f"{d.max().item()} to the plain version over tolerance")
        err_plain = max(err_plain, d.max().item())
        refs = fa.fused_relpos_attention_bwd_reference(*ops, gl, scale, rate)
        for name, a, r in zip(GRADS, grads, refs):
            a, r = a.float(), r.float()
            d = (a - r).abs()
            if not bool((d <= 2.0 ** -7 * (r.abs() + r.abs().max())).all()):
                raise AssertionError(f"row 4 {name} on part {h0}:{h1} of dim {dim}: "
                                     f"max |d| {d.max().item()} to the plain version")
            err_plain = max(err_plain, d.max().item())
        pairs = [(out, _heads_slice(full_out, h0, h1, dim))]
        pairs += [(a, _heads_slice(t, h0, h1, dim)) for a, t in zip(grads[:3], full_grads[:3])]
        if dim == 1:
            pairs += [(a, _heads_slice(t, h0, h1, 0)) for a, t in zip(grads[3:], full_grads[3:])]
        else:
            for acc, a in zip(summed, grads[3:]):
                acc += a.float()
        for a, r in pairs:
            err_full = max(err_full, (a.float() - r.float()).abs().max().item())
            bit_equal = bit_equal and torch.equal(a, r)
    if dim == 0:
        for acc, r in zip(summed, full_grads[3:]):
            err_full = max(err_full, (acc - r.float()).abs().max().item())
    return err_plain, err_full, bit_equal


def one_step_distance(run, ref):
    """Distances of one step at LR 0 (the parameters do not move): loss and
    aux terms, grad_norm and moments as `dp_distance` takes them, and a line
    of them."""
    d_aux = max(abs(run["aux"][0][k] - v) / abs(v) for k, v in ref["aux"][0].items()
                if k != "grad_norm" and v)
    d_norm = (abs(run["aux"][0]["grad_norm"] - ref["aux"][0]["grad_norm"])
              / ref["aux"][0]["grad_norm"])

    def norm(tensors):
        return sum(float(t.double().square().sum()) for t in tensors) ** 0.5

    d_mom = max(norm(run[part][k] - v for k, v in ref[part].items())
                / norm(ref[part].values()) for part in ("mu", "nu"))
    text = (f"loss/aux max relative |d|={d_aux:.3g} grad_norm {d_norm:.3g} moments "
            f"|d|/|ref| {d_mom:.3g} loss={run['aux'][0]['loss']:.6f} vs "
            f"{ref['aux'][0]['loss']:.6f}")
    return (d_aux, d_norm, d_mom), text


def tensor_parallel_phase(kernels, seed, smi, ref):
    """Step 21: rows 3-4 at a rank's local shape, then the TP step on two
    ranks of one card over gloo against the one-process step (`ref`, step
    20's run at dropout 0, and one step at dropout 0.1 here)."""
    from onebit_asr_tpu_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    cfg, params, batch = dp_setup(seed)
    err_plain, err_full, bit_equal = attention_parts_check(cfg, seed, 1, TP_SIZE)
    H = cfg.enc_heads // TP_SIZE
    log(f"tensor parallel: rows 3-4 at the local shape [16, {H}, 256, 64], dropout 0.1, each "
        f"head half: max |d| {err_plain:.3g} to the plain versions (within their tolerances); "
        f"to the same heads of one [16, {cfg.enc_heads}, 256, 64] launch max |d| "
        f"{err_full:.3g} bit_equal={bit_equal}")
    dropped = dp_run("one process", dataclasses.replace(cfg, dropout=0.1), params, batch,
                     make_mesh(), kernels, seed, steps=1, warmup=False)
    del params
    t0 = time.perf_counter()
    ranks = spawn_ranks(tp_rank_work, TP_SIZE, seed, "tensor parallel")
    wall = time.perf_counter() - t0
    per_step = {"ctc_alpha": 1, "ctc_beta": 1, "fused_relpos_attention": 3 * cfg.enc_layers,
                "fused_relpos_attention_bwd": 3 * cfg.enc_layers, "fused_subsample": 3,
                "fused_subsample_bwd": 3}
    log(f"tensor parallel: one process (step 20's run): ms_per_step={ref['ms']:.2f} "
        f"peak_mem_gb={ref['peak_gb']:.3f} [{smi}]")
    for dropout, steps, want in ((0.0, DP_STEPS, ref), (0.1, 1, dropped)):
        for r in ranks:
            run = r[dropout]
            log(f"tensor parallel: rank {r['coords']} (data, model) dropout {dropout}: "
                f"ms_per_step={run['ms']:.2f} peak_mem_gb={run['peak_gb']:.3f} launches="
                f"{run['counts']} heads a launch of rows 3-4 {run['heads']} [{smi}]")
            if run["counts"] != {k: steps * n for k, n in per_step.items()}:
                raise AssertionError(f"tensor parallel: rank {r['coords']} launches "
                                     f"{run['counts']}, want {per_step} x {steps}")
            if set(map(tuple, run["heads"].values())) != {(H,)}:
                raise AssertionError(f"tensor parallel: rows 3-4 ran on heads {run['heads']}, "
                                     f"want {H}")
        if len({r[dropout]["digest"] for r in ranks}) != 1:
            raise AssertionError(f"tensor parallel: the ranks' gathered states differ "
                                 f"(dropout {dropout})")
        got = as_tensors(ranks[0][dropout])
        if dropout == 0:
            dist_, _, text = dp_distance(got, want)
            bad = any(d > t for d, t in zip(dist_, TP_TOL))
        else:  # the LR is 0 at step 0: the parameters do not move
            dist_, text = one_step_distance(got, want)
            bad = any(d > t for d, t in zip(dist_, (DP_TOL[0], DP_TOL[1], DP_TOL[3])))
        log(f"tensor parallel: dropout {dropout}, ranks bit-equal, vs one process: {text}")
        if bad:
            raise AssertionError(f"tensor parallel: dropout {dropout} strays from the "
                                 f"one-process step: {dist_} beyond "
                                 f"{TP_TOL if dropout == 0 else DP_TOL}")
    log(f"tensor parallel: step 21 in {time.perf_counter() - t_phase:.2f} s (the two ranks "
        f"{wall:.2f} s)")


PP_STAGES, PP_MICRO = 2, 2  # step 22's mesh (data 1, stage 2) and microbatches
# step 22's limits on the pipelined step's distance to the one-process step,
# in DP_TOL's order: DP_TOL's, but loss and aux terms 3e-2. Microbatches sum
# each weight gradient over two products in another f32 order, and bf16
# rounds the activations of 8-row GEMMs apart from 16-row ones: on the card
# five runs read 9.07e-3 in loss/aux each (the same bits; a KL term), 1.27e-3
# with one microbatch, 1.47e-3 at f32 against the one-process step's own
# 2.56e-5 (scripts/pp_probe.py; PERF.md section 6, pipeline parallelism);
# the limit is 3x the reading, as TP_TOL's is
PP_TOL = (3e-2,) + DP_TOL[1:]


def pp_setup(seed, **flags):
    """Step 22's model (step 20's with the per-frame layer norm in the conv
    module: the pipeline refuses batch norm; `flags` over it), parameters
    and batch."""
    return dp_setup(seed, **{"conv_norm": "layer_norm", **flags})


def pp_rank_work(seed, micro=PP_MICRO, flags=None, dropouts=(0.0, 0.1)):
    """One rank of step 22: the pipelined step with `micro` microbatches at
    dropout 0 (a warm-up + DP_STEPS steps) and at 0.1 (one step from a
    fresh state), each with the rows of every rows-3-4 launch; rank 0 also
    returns the gathered states. `flags` over step 22's model, and
    `dropouts`, for scripts/pp_probe.py."""
    import torch.distributed as dist

    from onebit_asr_tpu_torch.convert import qat_model_from_jax
    from onebit_asr_tpu_torch.parallel.mesh import make_mesh
    from onebit_asr_tpu_torch.parallel.pipeline import (
        gather_state_pipeline,
        make_pipeline_train_step,
        shard_state_pipeline,
    )
    from onebit_asr_tpu_torch.train import AdamW, create_train_state
    from onebit_asr_tpu_torch.utils.config import LossConfig, OptimConfig, SpecialTokens

    kernels = smoke_kernels()
    rows = attention_shapes(0)
    mesh = make_mesh((1, PP_STAGES), ("data", "stage"))
    cfg, params, batch = pp_setup(seed, **(flags or {}))
    out = {"coords": mesh.coords}
    for dropout in dropouts:
        c = dataclasses.replace(cfg, dropout=dropout)
        model = qat_model_from_jax(c, params, device=DEVICE)
        state = create_train_state(model, seed)
        optimizer = AdamW(OptimConfig(warmup_steps=1), 100_000)
        step = make_pipeline_train_step(model, optimizer, LossConfig(), SpecialTokens(),
                                        c.enc_layers, mesh, micro)
        state = shard_state_pipeline(state, mesh)
        for p in model.parameters():  # as the CLI does: the step passes params in
            p.data = p.data.new_empty(0)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        for r in rows.values():
            r.clear()
        state, run = timed_steps_run(step, state, batch, kernels, base,
                                     *((DP_STEPS, True) if dropout == 0 else (1, False)))
        run["rows"] = {k: sorted(v) for k, v in rows.items()}
        full = gather_state_pipeline(state, mesh)
        run["digest"] = _digest(full)
        if dist.get_rank() == 0:  # numpy: a tensor crosses the queue as a handle
            run.update({part: {k: v.detach().cpu().numpy() for k, v in
                               getattr(full, part).items()} for part in ("params", "mu", "nu")})
        out[dropout] = run
        del model, state, full, step
        torch.cuda.empty_cache()
    return out


def pipeline_parallel_phase(kernels, seed, smi):
    """Step 22: rows 3-4 at a microbatch's shape, then the pipelined step on
    two ranks of one card over gloo against the one-process step on the same
    (layer-norm) model at dropout 0 and 0.1."""
    from onebit_asr_tpu_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    cfg, params, batch = pp_setup(seed)
    B, H = 16, cfg.enc_heads
    mb = B // PP_MICRO
    err_plain, err_full, bit_equal = attention_parts_check(cfg, seed, 0, PP_MICRO)
    log(f"pipeline parallel: rows 3-4 at the microbatch shape [{mb}, {H}, 256, 64], dropout "
        f"0.1, each half of the rows: max |d| {err_plain:.3g} to the plain versions (within "
        f"their tolerances); to the same rows of one [{B}, {H}, 256, 64] launch (dp, du, dvb: "
        f"the halves' sum) max |d| {err_full:.3g} bit_equal={bit_equal}")
    ref = dp_run("one process", cfg, params, batch, make_mesh(), kernels, seed)
    dropped = dp_run("one process", dataclasses.replace(cfg, dropout=0.1), params, batch,
                     make_mesh(), kernels, seed, steps=1, warmup=False)
    del params
    t0 = time.perf_counter()
    ranks = spawn_ranks(pp_rank_work, PP_STAGES, seed, "pipeline parallel")
    wall = time.perf_counter() - t0
    L = cfg.enc_layers
    per_stage = L // PP_STAGES
    log(f"pipeline parallel: one process (layer norm): ms_per_step={ref['ms']:.2f} "
        f"peak_mem_gb={ref['peak_gb']:.3f} launches={ref['counts']}; bubble fraction "
        f"(S-1)/(M+S-1) = {(PP_STAGES - 1) / (PP_MICRO + PP_STAGES - 1):.4f} (S={PP_STAGES}, "
        f"M={PP_MICRO}) [{smi}]")
    for dropout, steps, want in ((0.0, DP_STEPS, ref), (0.1, 1, dropped)):
        for r in ranks:
            run, first = r[dropout], r["coords"][1] == 0
            per_step = {"ctc_alpha": 1, "ctc_beta": 1,
                        "fused_relpos_attention": 3 * PP_MICRO * per_stage,
                        "fused_relpos_attention_bwd": 3 * PP_MICRO * per_stage,
                        **({"fused_subsample": 3, "fused_subsample_bwd": 3} if first else {})}
            log(f"pipeline parallel: rank {r['coords']} (data, stage) dropout {dropout}: "
                f"ms_per_step={run['ms']:.2f} peak_mem_gb={run['peak_gb']:.3f} launches="
                f"{run['counts']} rows a launch of rows 3-4 {run['rows']} [{smi}]")
            if run["counts"] != {k: steps * n for k, n in per_step.items()}:
                raise AssertionError(f"pipeline parallel: rank {r['coords']} launches "
                                     f"{run['counts']}, want {per_step} x {steps}")
            if set(map(tuple, run["rows"].values())) != {(mb,)}:
                raise AssertionError(f"pipeline parallel: rows 3-4 ran on rows {run['rows']}, "
                                     f"want {mb}")
        if len({r[dropout]["digest"] for r in ranks}) != 1:
            raise AssertionError(f"pipeline parallel: the ranks' gathered states differ "
                                 f"(dropout {dropout})")
        got = as_tensors(ranks[0][dropout])
        if dropout == 0:
            dist_, _, text = dp_distance(got, want)
            limits = PP_TOL
        else:  # the LR is 0 at step 0: the parameters do not move
            dist_, text = one_step_distance(got, want)
            limits = (PP_TOL[0], PP_TOL[1], PP_TOL[3])
        log(f"pipeline parallel: dropout {dropout}, ranks bit-equal, vs one process: {text}")
        if any(d > t for d, t in zip(dist_, limits)):
            raise AssertionError(f"pipeline parallel: dropout {dropout} strays from the "
                                 f"one-process step: {dist_} beyond {limits}")
    log(f"pipeline parallel: step 22 in {time.perf_counter() - t_phase:.2f} s (the two ranks "
        f"{wall:.2f} s)")


def train_cli_phase(kernels, root):
    """The training CLI at Conformer-M widths on the synthetic backend: two
    epochs as a program, then a third with --resume in this process; the
    runs stay under `root` for step 13."""
    from onebit_asr_tpu_torch.cli import train as tcli

    argv = ["--dummy_data", "--steps_per_epoch", "3", "--eval_batches", "1",
            "--batch_size", "16", "--save_dir", root, "--run_name", "smoke",
            "--device", DEVICE]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "onebit_asr_tpu_torch.train", "--epochs", "2", *argv],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO}, capture_output=True, text=True,
        timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"train CLI returned {proc.returncode}: {proc.stderr[-2000:]}")
    run = os.path.join(root, "smoke")
    for f in ("config.json", "metrics.jsonl", "ckpt/step_6.pt", "ckpt_best"):
        if not os.path.exists(os.path.join(run, f)):
            raise AssertionError(f"train CLI wrote no {f}")
    for line in proc.stdout.splitlines():
        log(f"train cli: {line}")
    log(f"train cli: rc=0 wall_s={wall:.2f} (process start, build load, init, 6 steps, "
        f"2 evaluations at 32/2/1 bits, checkpoints)")
    _reset(kernels)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tcli.main(["--epochs", "3", "--resume", *argv])
    counts = _counts(kernels)
    text = out.getvalue()
    for line in text.splitlines():
        log(f"train cli resume: {line}")
    # 3 steps (alpha + beta) and 3 precisions x 1 eval batch (alpha)
    want = {"ctc_alpha": 6, "ctc_beta": 3}
    if rc != 0 or "resumed at step 6 (epoch 2)" not in text or counts != want:
        raise AssertionError(f"train CLI --resume: rc={rc} launches {counts}, want {want}")
    if not os.path.exists(os.path.join(run, "ckpt", "step_9.pt")):
        raise AssertionError("train CLI --resume saved no step 9")
    log(f"train cli resume: rc=0 continued from step 6 to 9, launches={counts}")

    # one epoch under --fused_attention, then one under both fused flags:
    # 3 steps x 3 branches (the subsampler) x L blocks (the attention),
    # forward and backward, and 3 evaluation forwards (32/2/1 bits)
    from onebit_asr_tpu_torch.utils.config import ModelConfig

    L = ModelConfig().enc_layers
    attention = {"fused_relpos_attention": 9 * L + 3 * L, "fused_relpos_attention_bwd": 9 * L}
    for flags, name, want in (
            (["--fused_attention"], "smoke_fa", attention),
            (["--fused_subsampler", "--fused_attention"], "smoke_fs_fa",
             {**attention, "fused_subsample": 9 + 3, "fused_subsample_bwd": 9})):
        what = " ".join(f.lstrip("-") for f in flags)
        want = {"ctc_alpha": 6, "ctc_beta": 3, **want}
        _reset(kernels)
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = tcli.main(["--epochs", "1", *flags, *argv[:argv.index("--run_name")],
                            "--run_name", name, "--device", DEVICE])
        wall = time.perf_counter() - t0
        counts = _counts(kernels)
        for line in out.getvalue().splitlines():
            log(f"train cli {what}: {line}")
        run = os.path.join(root, name)
        if rc != 0 or counts != want or not os.path.exists(os.path.join(run, "ckpt",
                                                                         "step_3.pt")):
            raise AssertionError(f"train CLI {' '.join(flags)}: rc={rc} launches {counts}, "
                                 f"want {want}")
        log(f"train cli {what}: rc=0 wall_s={wall:.2f} (in process: init, 3 steps, "
            f"1 evaluation at 32/2/1 bits, checkpoint) launches={counts}")



SERVE_BEAM = 10
SERVE_LM_WEIGHT = 0.3
TIE_JITTER = 2.0 ** -12  # of a log-prob: breaks exact ties, far below any real gap
TIE_NATS = 1e-3  # relative: two hypotheses' fused scores this close are a tie
LONG_SECONDS = 75.0


def _hyps(path):
    """{utt_id: text} of a transcribe output."""
    with open(path) as f:
        return dict(line.rstrip("\n").split("\t") for line in f)


@contextlib.contextmanager
def decoded_ids():
    """Records the ids of every AsrTokenizer.ids_to_text call (any
    instance) for the duration, in call order: yields the list. A
    transcribe CLI decodes once a line, in the order of its lines."""
    from onebit_asr_tpu_torch.data.text import AsrTokenizer

    record, real = [], AsrTokenizer.ids_to_text

    def recording(self, ids):
        record.append([int(i) for i in ids])
        return real(self, ids)

    AsrTokenizer.ids_to_text = recording
    try:
        yield record
    finally:
        AsrTokenizer.ids_to_text = real


def _lines_ids(path, record):
    """{utt_id: the ids the CLI decoded into that line}."""
    with open(path) as f:
        uids = [line.split("\t")[0] for line in f]
    if len(uids) != len(record):
        raise AssertionError(f"{path}: {len(uids)} lines, {len(record)} decodes")
    return dict(zip(uids, record))


def _lm_for(vocab, seed):
    """A 3-gram LM fitted on seeded id sequences over the vocabulary's
    subword ids [4, vocab)."""
    from onebit_asr_tpu_torch.decode.lm import NGramLM

    rng = np.random.default_rng(seed)
    return NGramLM(3).fit([rng.integers(4, vocab, size=rng.integers(5, 40)).tolist()
                           for _ in range(500)])


def fused_score(lp, h, lm, lm_weight, blank_id=3):
    """log P_ctc(h | lp) through the plain lattice (every alignment, on the
    host) + lm_weight * log P_LM(h): the score a prefix beam approximates."""
    from onebit_asr_tpu_torch.losses.ctc import ctc_neg_log_likelihood

    labels = torch.tensor([h or [0]])
    nll = ctc_neg_log_likelihood(lp[None], torch.tensor([lp.shape[0]]), labels,
                                 torch.tensor([len(h)]), blank_id)
    lm_part = sum(lm.score(h[:i], c) for i, c in enumerate(h)) if lm is not None else 0.0
    return -float(nll[0]) + lm_weight * lm_part


def beam_agreement(what, lp, lens, lm, dlm):
    """The device beam (beam_search_device, on the card) against the native
    host beam (C++, on the same f32 log-probs copied to the host), beam 10,
    with `lm` (and its device tables `dlm`) or without (both None),
    top-k 20, max_len T' (every frame may emit). Equal log-probs are common
    here (bf16 logits), and the two beams break such ties differently:
    torch's stable sort puts the lower index first, the C++ nth_element and
    hash map in no fixed order. So where the hypotheses differ, the
    difference counts as a tie when (a) both beams agree once every
    log-prob is shifted by its own seeded jitter in [0, 2^-12) (no exact
    ties left), or (b) the two hypotheses' fused scores through the plain
    lattice (`fused_score`) lie within TIE_NATS relative of each other.
    Anything else is a bug and raises. Prints how many differed and how
    many were ties by (a) and by (b)."""
    from onebit_asr_tpu_torch.decode import ctc_beam_search_batch
    from onebit_asr_tpu_torch.decode.beam_device import beam_search_device

    w = SERVE_LM_WEIGHT if lm is not None else 0.0
    B = lp.shape[0]

    def both(x):
        ids, n = beam_search_device(x, lens, beam_size=SERVE_BEAM, max_len=x.shape[1], lm=dlm,
                                    lm_weight=w)
        ids, n = ids.cpu(), n.cpu()
        dev = [ids[b, : n[b]].tolist() for b in range(B)]
        host = ctc_beam_search_batch(x.cpu().numpy(), lens.cpu().numpy(), beam_size=SERVE_BEAM,
                                     lm=lm, lm_weight=w)
        return dev, host

    dev, host = both(lp)
    differ = [b for b in range(B) if dev[b] != host[b]]
    ties_a, ties_b, gaps = [], [], []
    if differ:
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        jitter = torch.rand(lp.shape, generator=gen, device=DEVICE) * TIE_JITTER
        dev_j, host_j = both(lp + jitter)
        for b in differ:
            if dev_j[b] == host_j[b]:
                ties_a.append(b)
                continue
            x = lp[b, : int(lens[b])].cpu()
            s_dev, s_host = fused_score(x, dev[b], lm, w), fused_score(x, host[b], lm, w)
            if abs(s_dev - s_host) > TIE_NATS * abs(s_host):
                raise AssertionError(f"serve beam {what}: utterance {b}: device and host "
                                     f"hypotheses differ past a tie (fused scores {s_dev:.4f} "
                                     f"vs {s_host:.4f}; with jitter they still differ)")
            ties_b.append(b)
            gaps.append(f"{s_dev - s_host:+.4f} of {s_host:.1f}")
    lengths = [len(h) for h in dev]
    log(f"serve beam {what}: device vs native host beam (beam {SERVE_BEAM}, lm_weight {w}): "
        f"{B - len(differ)}/{B} equal, {len(differ)} differed: {len(ties_a)} ties resolved by "
        f"jitter, {len(ties_b)} ties by fused score (device - host: {', '.join(gaps) or '-'}); "
        f"hypothesis lengths {lengths}")


def _compare_frames(name, lp, lp_ref):
    """mean/max |d log p| and argmax agreement of two [T, V] log-probs, at
    step 3's tolerances."""
    if lp.shape != lp_ref.shape or not bool(torch.isfinite(lp).all()):
        raise AssertionError(f"{name}: log-probs {tuple(lp.shape)} vs {tuple(lp_ref.shape)}")
    d = (lp - lp_ref).abs()
    agree = (lp.argmax(-1) == lp_ref.argmax(-1)).float().mean().item()
    log(f"serve {name}: frames={lp.shape[0]} logprob max|d|={d.max().item():.4g} "
        f"mean|d|={d.mean().item():.4g} argmax_agree={agree:.4f}")
    if d.mean().item() > 0.05 or agree < 0.9:
        raise AssertionError(f"{name}: kernel path strays from the plain path")


def serve_phase(root, kernels, seed):
    """Step 13: serve and evaluate the runs step 8 trained (Conformer-M at
    full width, vocabulary 32 of the synthetic backend) through the CLIs a
    user calls, on the card; see the module docstring. Returns what to
    count kernel launches of at the end: (label, one batch)."""
    from onebit_asr_tpu_torch.cli import evaluate as ecli
    from onebit_asr_tpu_torch.cli import transcribe as cli
    from onebit_asr_tpu_torch.convert import init_params, jax_tree_from_state_dict
    from onebit_asr_tpu_torch.decode.lm_device import DeviceLM
    from onebit_asr_tpu_torch.model.presets import apply_preset
    from onebit_asr_tpu_torch.ops.frontend import LogMelFrontend
    from onebit_asr_tpu_torch.utils.checkpoint import load_config, restore_params
    from onebit_asr_tpu_torch.utils.config import ModelConfig, TrainConfig

    t_phase = time.perf_counter()
    wavs = synthetic_waveforms(seed)
    batch, lens = pcm_batch(wavs)
    cmvn = cmvn_of(batch, lens)
    inputs = os.path.join(root, "serve")
    paths = {k: os.path.join(inputs, k) for k in ("wavs", "data", "long", "lm.npz")}
    write_wavs(paths["wavs"], wavs)
    write_cmvn(paths["data"], cmvn)
    # a `--checkpoint` run needs its tokenizer: one over the runs' vocabulary
    from onebit_asr_tpu_torch.data.text import AsrTokenizer

    tok = AsrTokenizer.load(write_char_tokenizer(paths["data"]))
    rng = np.random.default_rng(seed + 13)
    secs = np.arange(int(LONG_SECONDS * SAMPLE_RATE)) / SAMPLE_RATE
    long_wav = (0.05 * sum(np.sin(2 * np.pi * f * secs + rng.uniform(0, 6.3))
                           for f in rng.uniform(100.0, 3000.0, size=4))
                + 0.01 * rng.standard_normal(secs.shape)).astype(np.float32)
    write_wavs(paths["long"], [long_wav], ["long"])

    runs = {}
    for name in ("smoke", "smoke_fs_fa"):
        run_dir = os.path.join(root, name)
        cfg = load_config(run_dir)
        _, sd = restore_params(os.path.join(run_dir, "ckpt"))
        runs[name] = (run_dir, cfg, jax_tree_from_state_dict(sd, cfg.model))
    vocab = runs["smoke"][1].model.vocab_size
    lm = _lm_for(vocab, seed)
    lm.save(paths["lm.npz"])
    L = 9 * runs["smoke"][1].model.enc_layers
    blocks = runs["smoke"][1].model.enc_layers
    fused = {"fused_subsample": 1, "fused_relpos_attention": blocks}

    def transcribe(label, run, extra, want, wav_dir=paths["wavs"]):
        out = os.path.join(inputs, f"hyp_{label.replace(' ', '_')}.tsv")
        _reset(kernels)
        t0 = time.perf_counter()
        with decoded_ids() as record:
            rc = cli.main(["--checkpoint", runs[run][0], "--wav_dir", wav_dir, "--data_dir",
                           paths["data"], "--batch_size", str(BATCH), "--out", out,
                           "--device", DEVICE, *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts(kernels)
        if rc != 0 or counts != want:
            raise AssertionError(f"serve {label}: rc={rc} launches {counts}, want {want}")
        hyps = _hyps(out)
        log(f"serve cli {label}: transcribe --checkpoint {run} {' '.join(extra)}: rc=0 "
            f"launches={counts} utterances={len(hyps)} wall_s={wall:.2f}")
        return hyps, _lines_ids(out, record)

    # the batch as the CLI makes it (length-sorted), so that the Transcriber
    # sees the same rows in the same order (batch statistics)
    fe = LogMelFrontend(runs["smoke"][1].frontend)
    max_samples = fe.frame_len + (runs["smoke"][1].data.max_frames - 1) * fe.frame_shift
    wb = next(cli._wav_dir_batches(paths["wavs"], BATCH, max_samples))

    def same_ids(label, served, t):
        hyps, got = served
        ids, n = t.transcribe(wb["wavs"], wb["wav_lens"])
        want = {u: [int(i) for i in ids[b, : n[b]]] for b, u in enumerate(wb["utt_ids"])}
        text = {u: tok.ids_to_text(v) for u, v in want.items()}
        if got != want or hyps != text:
            bad = [u for u in want if got.get(u) != want[u] or hyps.get(u) != text[u]]
            raise AssertionError(f"serve {label}: the CLI's ids or text differ from the "
                                 f"Transcriber's on {bad}")

    # packed serving: each run's packed kernel 108 times a batch
    for label, run, extra, precision, int8_act, want in (
            ("packed p2", "smoke", [], 2, False, {"ternary_matmul_bf16": L}),
            ("packed p1", "smoke", ["--precision", "1"], 1, False, {"ternary_matmul_bf16": L}),
            ("packed int8", "smoke", ["--int8_act"], 2, True, {"ternary_matmul_w2a8": L}),
            ("packed fused", "smoke_fs_fa", [], 2, False, {"ternary_matmul_bf16": L, **fused})):
        served = transcribe(label, run, ["--packed", *extra], want)
        _, cfg, tree = runs[run]
        same_ids(label, served, cli.Transcriber(cfg, tree, precision, int8_act, cmvn, DEVICE))
    log("serve packed: the ids the CLI decoded equal Transcriber's on jax_tree_from_state_dict "
        "of the restored parameters exactly, and its text equals theirs decoded")

    # unpacked serving: the QAT model; under the fused flags their kernels
    transcribe("unpacked p2 unfused", "smoke", [], {})
    for precision in (32, 2, 1):
        label = f"unpacked p{precision}"
        served = transcribe(label, "smoke_fs_fa", ["--precision", str(precision)], fused)
        _, cfg, tree = runs["smoke_fs_fa"]
        t = cli.Transcriber(cfg, tree, precision, cmvn=cmvn, device=DEVICE, packed=False)
        same_ids(label, served, t)
        lp, enc_lens = t.log_probs(wb["wavs"], wb["wav_lens"])
        _use_plain(t.model, False)
        lp_ref, _ = t.log_probs(wb["wavs"], wb["wav_lens"])
        _, dmax, dmean, agree = _compare(label, lp, lp_ref, enc_lens, cfg.model.vocab_size,
                                         cfg.model.time_pad_multiple)
        log(f"serve {label}: vs the same QAT model on the plain versions: logprob "
            f"max|d|={dmax:.4g} mean|d|={dmean:.4g} argmax_agree={agree:.4f}")
        if dmean > 0.05 or agree < 0.9:
            raise AssertionError(f"serve {label}: kernel path strays from the plain path")
        del t

    # the beam: the CLI, then the device beam against the native host beam
    transcribe("beam", "smoke", ["--packed", "--beam_size", str(SERVE_BEAM)],
               {"ternary_matmul_bf16": L})
    transcribe("beam lm", "smoke", ["--packed", "--beam_size", str(SERVE_BEAM), "--lm",
                                    paths["lm.npz"], "--lm_weight", str(SERVE_LM_WEIGHT)],
               {"ternary_matmul_bf16": L})
    _, cfg, tree = runs["smoke"]
    served = {f"trained run, V={vocab}": (cli.Transcriber(cfg, tree, 2, cmvn=cmvn, device=DEVICE),
                                          lm)}
    m_cfg = apply_preset(ModelConfig(), "m")
    served[f"random Conformer-M, V={m_cfg.vocab_size}"] = (
        cli.Transcriber(TrainConfig(model=m_cfg), init_params(m_cfg, seed), 2, cmvn=cmvn,
                       device=DEVICE),
        _lm_for(m_cfg.vocab_size, seed))
    counted = []
    for what, (t, lm_) in served.items():
        lp, enc_lens = t.log_probs(batch, lens)
        dlm = DeviceLM.pack(lm_, DEVICE)
        beam_agreement(what, lp, enc_lens, None, None)
        beam_agreement(f"{what} + 3-gram LM", lp, enc_lens, lm_, dlm)
        for mode, beam, fused_lm in (("greedy", 0, None), (f"beam {SERVE_BEAM}", SERVE_BEAM, None),
                                     (f"beam {SERVE_BEAM} + LM", SERVE_BEAM, dlm)):
            t.beam_size, t.lm, t.lm_weight = beam, fused_lm, SERVE_LM_WEIGHT
            ms = cuda_ms(lambda: t.transcribe(batch, lens), iters=2, warmup=1)
            dec_ms = cuda_ms(lambda: t.decode(lp, enc_lens), iters=2, warmup=0)
            log(f"serve time {what}, {mode}: B={BATCH} T'={lp.shape[1]} (valid <= "
                f"{int(enc_lens.max())}) ms_per_batch={ms:.2f} decode_ms={dec_ms:.2f}")
            counted.append((f"{what}, {mode}", (lambda t=t, b=beam, l=fused_lm: (
                setattr(t, "beam_size", b), setattr(t, "lm", l), t.transcribe(batch, lens)))))

    # long-form: 75 s in 30 s windows overlapping by 4 s
    hyps, got = transcribe("longform", "smoke_fs_fa", [
        "--packed", "--longform", "--chunk_seconds", "30", "--overlap_seconds", "4"],
        {"ternary_matmul_bf16": L, **fused}, wav_dir=paths["long"])
    _, cfg, tree = runs["smoke_fs_fa"]
    t = cli.Transcriber(cfg, tree, 2, cmvn=cmvn, device=DEVICE)
    chunk, overlap = t.longform_frames(30.0, 4.0)
    pcm = pcm16(long_wav).astype(np.float32) / 32768.0
    frames = 1 + (len(pcm) - t.frontend.frame_len) // t.frontend.frame_shift
    windows = max(1, -(-max(frames - overlap, 1) // (chunk - overlap)))
    ids = [int(i) for i in t.longform(pcm, chunk, overlap)]
    if windows != 3 or got["long"] != ids or hyps["long"] != tok.ids_to_text(ids):
        raise AssertionError(f"serve longform: {windows} windows, or the CLI's ids or text "
                             f"differ")
    lp = t.longform_log_probs(pcm, chunk, overlap)
    _use_plain(t.model, False)
    _compare_frames(f"longform ({LONG_SECONDS:.0f} s, {windows} windows of {chunk} frames, "
                    f"overlap {overlap}) vs plain", lp, t.longform_log_probs(pcm, chunk, overlap))
    del t

    # evaluate: loss, WER and CER per precision on the synthetic batches
    for extra, want in (
            (["--greedy"], {"ctc_alpha": 3}),
            (["--beam_size", str(SERVE_BEAM)], {"ctc_alpha": 3}),
            (["--packed"], {"ctc_alpha": 1, "ternary_matmul_bf16": L})):
        _reset(kernels)
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = ecli.main(["--checkpoint", runs["smoke"][0], "--dummy_data", "--max_batches",
                            "1", "--device", DEVICE, *extra])
        wall = time.perf_counter() - t0
        counts = _counts(kernels)
        for line in out.getvalue().splitlines():
            log(f"serve eval {' '.join(extra)}: {line}")
        if rc != 0 or counts != want or "WER" not in out.getvalue():
            raise AssertionError(f"evaluate {extra}: rc={rc} launches {counts}, want {want}")
        log(f"serve eval {' '.join(extra)}: rc=0 launches={counts} wall_s={wall:.2f}")
    log(f"serve: phase wall_s={time.perf_counter() - t_phase:.2f}")
    export_beam_part(runs["smoke"], paths["lm.npz"], cmvn, batch, lens, kernels, inputs)
    return counted


def export_beam_part(run, lm_path, cmvn, batch, lens, kernels, root):
    """Step 19 (e): step 13's run exported packed with emit=beam and step 13's
    3-gram LM baked in, through the export CLI, at EXPORT_BEAM_FRAMES raw
    frames (the artifact unrolls its frame loop, ~430 graph nodes a frame
    with the LM: export, save and load grow with T'); its ids on step 3's
    features cut to those frames (lengths 35, 33, ..., 21) must equal the
    live device beam's (Transcriber.decode) on the live packed forward."""
    from onebit_asr_tpu_torch.cli import export as export_cli
    from onebit_asr_tpu_torch.cli import transcribe as cli
    from onebit_asr_tpu_torch.decode.lm import NGramLM
    from onebit_asr_tpu_torch.decode.lm_device import DeviceLM
    from onebit_asr_tpu_torch.export import greedy_ids_to_lists, load_artifact

    smi = smi_line()
    run_dir, cfg, tree = run
    art = os.path.join(root, "beam_lm.export")
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = export_cli.main(["offline", "--checkpoint", run_dir, "--out", art, "--packed",
                              "--batch", str(BATCH), "--frames", str(EXPORT_BEAM_FRAMES),
                              "--emit", "beam", "--beam_size", str(SERVE_BEAM), "--lm", lm_path,
                              "--lm_weight", str(SERVE_LM_WEIGHT)])
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fn, meta = load_artifact(art)
    load_s = time.perf_counter() - t0
    mb = os.path.getsize(os.path.join(art, "module.pt2")) / 1e6
    t = cli.Transcriber(cfg, tree, 2, cmvn=cmvn, device=DEVICE, beam_size=SERVE_BEAM,
                        lm=DeviceLM.pack(NGramLM.load(lm_path), DEVICE),
                        lm_weight=SERVE_LM_WEIGHT)
    feats, _ = t.featurize(batch, lens)
    x = feats[:, :EXPORT_BEAM_FRAMES].clone()
    xl = torch.tensor([EXPORT_BEAM_FRAMES - 2 * b for b in range(BATCH)], device=DEVICE)

    @torch.no_grad()
    def live():
        _, mask, logits = t.model(x, xl, t.binary_mask)
        return t.decode(torch.log_softmax(logits.float(), -1), mask.sum(-1))

    _reset(kernels)
    ids_a, n_a = fn(x, xl)
    torch.cuda.synchronize()
    counts = _counts(kernels)
    got, want = greedy_ids_to_lists(ids_a, n_a), greedy_ids_to_lists(*live())
    ms_a = cuda_ms(lambda: fn(x, xl), iters=3, warmup=1)
    ms_l = cuda_ms(live, iters=3, warmup=1)
    log(f"export (e) beam {SERVE_BEAM} + 3-gram LM, packed p2, B={BATCH} T={EXPORT_BEAM_FRAMES} "
        f"T'={ids_a.shape[1]}: export CLI rc={rc} export+save_s={export_s:.2f} "
        f"load_s={load_s:.2f} module_mb={mb:.2f} launches={counts} ids equal to the live "
        f"device beam's: {got == want} (tokens {sum(map(len, got))}) ms_per_batch "
        f"artifact={ms_a:.2f} live={ms_l:.2f} [{smi}]")
    if rc != 0 or got != want or counts != {"ternary_matmul_bf16": 9 * cfg.model.enc_layers}:
        raise AssertionError(f"export (e): rc={rc} launches {counts}, or the beam artifact's "
                             f"ids differ from the live beam's: {got} vs {want}")


@contextlib.contextmanager
def counted_frontend():
    """Counts LogMelFrontend calls (any instance, any thread) for the
    duration: yields a one-element list."""
    from onebit_asr_tpu_torch.ops.frontend import LogMelFrontend

    calls, real = [0], LogMelFrontend.__call__

    def counting(self, *a, **k):
        calls[0] += 1
        return real(self, *a, **k)

    LogMelFrontend.__call__ = counting
    try:
        yield calls
    finally:
        LogMelFrontend.__call__ = real


@contextlib.contextmanager
def timed_steps():
    """Every train step made by train.make_train_step for the duration (also
    the K steps of make_multi_train_step), recorded as (T of its feats,
    CUDA start event, end event) in the yielded list."""
    import onebit_asr_tpu_torch.train as train_pkg
    from onebit_asr_tpu_torch.train import step as step_mod

    record, real = [], step_mod.make_train_step

    def make(*a, **k):
        step = real(*a, **k)

        def timed(state, batch):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = step(state, batch)
            end.record()
            record.append((int(batch["feats"].shape[1]), start, end))
            return out
        return timed

    train_pkg.make_train_step = step_mod.make_train_step = make
    try:
        yield record
    finally:
        train_pkg.make_train_step = step_mod.make_train_step = real


def aux_err(a, ref):
    """The largest relative difference of the aux terms of `a` from `ref`."""
    return max(abs(a[k] - ref[k]) / abs(ref[k]) for k in ref)


def plain_pairs(model):
    """(what, swap to it, aux tolerance, gradient tolerance, the kernel rows
    it replaces) for each kernel pair of a train step under both fused
    flags: step 7's tolerances."""
    from onebit_asr_tpu_torch.ops import attention as fa
    from onebit_asr_tpu_torch.ops import subsampler as ss

    return (("plain attention", lambda: swapped_attention(model, fa.fused_relpos_attention_plain),
             1e-2, 0.1, ("fused_relpos_attention", "fused_relpos_attention_bwd")),
            ("plain subsampler", lambda: swapped_subsample(model, ss.fused_subsample_plain),
             1e-2, 0.1, ("fused_subsample", "fused_subsample_bwd")),
            ("plain CTC", plain_ctc, 1e-4, 1e-2, ("ctc_alpha", "ctc_beta")))


def launched(kernels, fn):
    """(fn(), the launches it made), the card synchronized."""
    _reset(kernels)
    out = fn()
    torch.cuda.synchronize()
    return out, _counts(kernels)


def held_against_plain(kernels, model, step, want, what):
    """`step()` -> (aux floats, grads): one step through `model`. On the
    kernels it must launch exactly `want`; with each kernel pair of
    plain_pairs on its plain version in turn, the swapped rows must not
    launch and the aux terms and gradients must stay within step 7's
    tolerances."""
    (aux_k, grads_k), counts = launched(kernels, step)
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, want {want}")
    for plain, swap, aux_tol, grad_tol, rows in plain_pairs(model):
        with swap():
            (aux_p, grads_p), counts_p = launched(kernels, step)
        err, (grad_err, _) = aux_err(aux_k, aux_p), _grads_cmp(grads_k, grads_p)
        del grads_p
        log(f"{what} vs {plain}: aux max relative |d|={err:.3g} (tolerance {aux_tol}) "
            f"grads |d|/|g|={grad_err:.3g} (tolerance {grad_tol}) loss="
            f"{aux_k['loss']:.6g}/{aux_p['loss']:.6g} plain launches={counts_p}")
        if any(counts_p.get(k) for k in rows) or err > aux_tol or grad_err > grad_tol:
            raise AssertionError(f"{what}: the kernels stray from the {plain} (or the plain "
                                 f"run launched them: {counts_p})")


def train_cli_run(kernels, argv, want, what, *watch):
    """The train CLI in process on `argv` (which names --save_dir and
    --run_name), its output logged under `what`: it must exit 0, launch
    exactly `want` and log finite train losses. Every train step is timed
    (CUDA events) and the context managers `watch` are held around the run.
    -> (run dir, metrics lines, [(T, ms)] per step, launches, peak memory
    above the start in GB, wall s, what each of `watch` yielded)."""
    from types import SimpleNamespace

    from onebit_asr_tpu_torch.cli import train as tcli

    _reset(kernels)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        record = stack.enter_context(timed_steps())
        watched = [stack.enter_context(w) for w in watch]
        stack.enter_context(contextlib.redirect_stdout(out))
        rc = tcli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    counts = _counts(kernels)
    for line in out.getvalue().splitlines():
        log(f"{what}: {line}")
    if rc != 0 or counts != want:
        raise AssertionError(f"{what}: rc={rc} launches {counts}, want {want}")
    run = os.path.join(argv[argv.index("--save_dir") + 1], argv[argv.index("--run_name") + 1])
    with open(os.path.join(run, "metrics.jsonl")) as f:
        metrics = [json.loads(line) for line in f]
    if not all(np.isfinite(m["train_loss"]) for m in metrics):
        raise AssertionError(f"{what}: metrics {metrics}")
    return SimpleNamespace(run=run, metrics=metrics, counts=counts, peak_gb=peak_gb, wall=wall,
                           step_ms=[(T, s.elapsed_time(e)) for T, s, e in record],
                           watched=watched)


def bucket_kernel_check(kernels, run, dm, seed):
    """Rows 3-8 at the shapes the real-data run gave them. For the first
    training batch of each length bucket (SpecAugment on), one step's loss
    and gradients on the kernels against the same step, from the same
    parameters, mask and dropout seeds, with each kernel pair on its plain
    version in turn (step 7's tolerances); then the forward without a
    gradient (rows 3 and 5 in their serving form, row 7 without row 8)
    against every plain version at once. The run's config; random weights
    from `seed`."""
    from onebit_asr_tpu_torch.convert import init_params, qat_model_from_jax
    from onebit_asr_tpu_torch.train import create_train_state
    from onebit_asr_tpu_torch.train.step import (batch_to_device, make_batch_loss,
                                                 sample_sp_mask, value_and_grad)
    from onebit_asr_tpu_torch.utils.checkpoint import load_config
    from onebit_asr_tpu_torch.utils.config import LossConfig

    cfg = load_config(run).model
    L = cfg.enc_layers
    model = qat_model_from_jax(cfg, init_params(cfg, seed), device=DEVICE)
    params = create_train_state(model, seed).params
    batch_loss = make_batch_loss(model, LossConfig(), cfg.specials, L)
    sp = sample_sp_mask(torch.Generator().manual_seed(seed + 1), L)
    batches = {}
    for b in dm.featurized_batches("train", 0, augment=True):
        batches.setdefault(int(b["feats"].shape[1]), batch_to_device(b, DEVICE))

    def run_(batch, grad=True):
        gens = [torch.Generator(device=DEVICE).manual_seed(seed + i) for i in range(3)]
        if grad:
            (_, aux), grads = value_and_grad(batch_loss, params, batch, sp, gens)
        else:
            with torch.no_grad():
                _, aux = batch_loss(params, batch, sp, gens)
            grads = None
        return {k: float(v) for k, v in aux.items()}, grads

    want = {"ctc_alpha": 1, "ctc_beta": 1, "fused_relpos_attention": 3 * L,
            "fused_relpos_attention_bwd": 3 * L, "fused_subsample": 3, "fused_subsample_bwd": 3}
    want_fwd = {"ctc_alpha": 1, "fused_relpos_attention": 3 * L, "fused_subsample": 3}
    for T, batch in sorted(batches.items()):
        what = (f"real data kernels at B={batch['feats'].shape[0]} T={T} "
                f"(T'={padded_frames(T, cfg)})")
        held_against_plain(kernels, model, lambda: run_(batch), want, what)
        (aux_k, _), counts = launched(kernels, lambda: run_(batch, grad=False))
        with contextlib.ExitStack() as stack:
            for _, swap, *_ in plain_pairs(model):
                stack.enter_context(swap())
            (aux_p, _), counts_p = launched(kernels, lambda: run_(batch, grad=False))
        err = aux_err(aux_k, aux_p)
        log(f"{what}, forward alone vs every plain version: aux max relative |d|={err:.3g} "
            f"(tolerance 1e-2) launches={counts}")
        if counts != want_fwd or counts_p or err > 1e-2:
            raise AssertionError(f"{what}, forward alone: launches {counts}, want {want_fwd}, "
                                 f"plain {counts_p}; aux |d| {err:.3g}")
    return sorted(batches)


def padded_frames(T, cfg):
    """T' of T frames: subsampled, padded to the model's multiple."""
    from onebit_asr_tpu_torch.model.conformer import subsampled_frames

    return -(-subsampled_frames(T) // cfg.time_pad_multiple) * cfg.time_pad_multiple


REAL_EPOCHS, REAL_STEPS = 2, 3  # steps per epoch: one batch of each of the 3 buckets


def real_data_phase(kernels, seed, smi):
    """Step 14: the real-data path at Conformer-M full width through the
    CLIs a user calls, on a seeded data dir; see the module docstring."""
    from onebit_asr_tpu_torch.cli import evaluate as ecli
    from onebit_asr_tpu_torch.cli import transcribe as cli
    from onebit_asr_tpu_torch.convert import jax_tree_from_state_dict
    from onebit_asr_tpu_torch.data.librispeech import LibriSpeechDataModule
    from onebit_asr_tpu_torch.data.text import AsrTokenizer
    from onebit_asr_tpu_torch.ops.specaugment import draw_starts, spec_augment_from_config
    from onebit_asr_tpu_torch.utils.checkpoint import load_config, restore_params
    from onebit_asr_tpu_torch.utils.config import DataConfig, ModelConfig

    t_phase = time.perf_counter()
    build_root = os.path.join(REPO, "onebit_asr_tpu_torch", "_build")
    os.makedirs(build_root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_root) as root:
        t0 = time.perf_counter()
        data, cached = write_data_dir(root, seed)
        n_utts = {split: n for split, n in DATA_SPLITS}
        log(f"real data: wrote {n_utts} utterances of 2-10 s (+ the float16 feature cache) "
            f"in {time.perf_counter() - t0:.2f} s")
        tok = AsrTokenizer.find_and_load(data)

        # SpecAugment on the card against the CPU on the same starts
        dm = LibriSpeechDataModule(data, tok, DataConfig(data_dir=data, batch_size=16,
                                                         num_buckets=3), device=DEVICE)
        b = next(dm.featurized_batches("train", 0))
        lens = b["feat_lens"].cpu()
        starts = torch.from_numpy(draw_starts(np.random.default_rng(seed), lens.numpy(),
                                              b["feats"].shape[-1], dm.frontend.cfg))
        for dtype in (torch.float32, torch.float16):
            x = b["feats"].to(dtype)
            got = spec_augment_from_config(x, b["feat_lens"], starts.to(DEVICE),
                                           dm.frontend.cfg).cpu()
            want = spec_augment_from_config(x.cpu(), lens, starts, dm.frontend.cfg)
            if not torch.equal(got, want):
                raise AssertionError(f"real data: SpecAugment on the card differs from the CPU "
                                     f"({dtype})")
            log(f"real data: SpecAugment {dtype} B={x.shape[0]} T={x.shape[1]} on the card "
                f"equals the CPU bit for bit on the same starts ({int((got == 0).sum())} "
                f"zeros)")

        # train: Conformer-M under both fused flags, SpecAugment on, prefetch 4
        L = ModelConfig().enc_layers
        argv = ["--preset", "m", "--batch_size", "16", "--num_buckets", "3",
                "--eval_batches", "1", "--fused_attention", "--fused_subsampler",
                "--prefetch_depth", "4", "--save_dir", root, "--device", DEVICE]

        def want_train(steps, evals):
            return {"ctc_alpha": steps + 3 * evals, "ctc_beta": steps,
                    "fused_relpos_attention": 3 * L * (steps + evals),
                    "fused_relpos_attention_bwd": 3 * L * steps,
                    "fused_subsample": 3 * (steps + evals), "fused_subsample_bwd": 3 * steps}

        def train(label, data_dir, epochs, steps):
            r = train_cli_run(kernels, ["--data_dir", data_dir, "--epochs", str(epochs),
                                        "--steps_per_epoch", str(steps), "--run_name", label,
                                        *argv],
                              want_train(epochs * steps, epochs), f"real data train {label}",
                              counted_frontend())
            metrics, step_ms, counts, peak_gb, (fe_calls,) = (r.metrics, r.step_ms, r.counts,
                                                               r.peak_gb, r.watched)
            if len(metrics) != epochs or not all(0.0 <= m["input_wait_frac"] <= 1.0
                                                 for m in metrics):
                raise AssertionError(f"real data train {label}: metrics {metrics}")
            per_T = {T: [round(ms, 2) for t, ms in step_ms if t == T]
                     for T in sorted({T for T, _ in step_ms})}
            log(f"real data train {label}: rc=0 wall_s={r.wall:.2f} steps={len(step_ms)} "
                f"launches={counts} (per step: 1 + 1 lattice, 3 + 3 subsampler, {3 * L} + "
                f"{3 * L} attention; per evaluation 3 x (1 lattice, 1 subsampler, {L} "
                f"attention)) frontend_calls={fe_calls[0]}")
            log(f"real data train {label}: ms_per_step by T {per_T} (CUDA events around the "
                f"step, the producer's work queued between them included; first of each T "
                f"a warm-up) median_ms={float(np.median([ms for _, ms in step_ms])):.2f} "
                f"input_wait_frac={[round(m['input_wait_frac'], 4) for m in metrics]} "
                f"train_loss={[round(m['train_loss'], 4) for m in metrics]} "
                f"peak_mem_gb={peak_gb:.3f} [{smi}]")
            REAL_TRAIN[label] = {"ms_per_step_by_T": per_T, "peak_mem_gb": round(peak_gb, 3)}
            return per_T, fe_calls[0]

        per_T, fe_calls = train("real", data, REAL_EPOCHS, REAL_STEPS)
        if len(per_T) < 2 or fe_calls == 0:
            raise AssertionError(f"real data train: bucket lengths {sorted(per_T)}, "
                                 f"frontend calls {fe_calls}")
        checked = bucket_kernel_check(kernels, os.path.join(root, "real"), dm, seed)
        dm.close()
        if checked != sorted(per_T):
            raise AssertionError(f"real data: kernels checked at T {checked}, the run's T "
                                 f"{sorted(per_T)}")
        log(f"real data train: beside step 7's synthetic step (B=16, T=1024) ms_per_step "
            f"{ {k: round(v, 2) for k, v in STEP_MS.items()} } [{smi}]")
        _, fe_calls = train("real_cached", cached, 1, 2)
        if fe_calls:
            raise AssertionError(f"real data train on the feature cache called the frontend "
                                 f"{fe_calls} times")

        # evaluate dev and test: per batch and precision one lattice launch
        run = os.path.join(root, "real")
        _reset(kernels)
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = ecli.main(["--checkpoint", run, "--data_dir", data, "--splits", "dev,test",
                            "--greedy", "--device", DEVICE])
        wall = time.perf_counter() - t0
        counts = _counts(kernels)
        for line in out.getvalue().splitlines():
            log(f"real data eval: {line}")
        want = {"ctc_alpha": 6, "fused_relpos_attention": 6 * L, "fused_subsample": 6}
        if rc != 0 or counts != want or out.getvalue().count("CER") != 6:
            raise AssertionError(f"real data eval: rc={rc} launches {counts}, want {want}")
        log(f"real data eval: rc=0 dev,test (1 batch each) x 32/2/1 bits launches={counts} "
            f"wall_s={wall:.2f}")

        # transcribe the test split packed: 108 packed launches a batch
        cfg = load_config(run)
        _, sd = restore_params(os.path.join(run, "ckpt"))
        tree = jax_tree_from_state_dict(sd, cfg.model)
        dm = LibriSpeechDataModule(data, tok, DataConfig(data_dir=data, batch_size=BATCH),
                                   splits=("test",), frontend_cfg=cfg.frontend, device=DEVICE)
        with np.load(os.path.join(data, "cmvn_stats.npz")) as stats:
            cmvn = (stats["mean"], stats["std"])
        fused = {"fused_subsample": 1, "fused_relpos_attention": L}
        for extra, int8_act, want in (
                ([], False, {"ternary_matmul_bf16": 9 * L, **fused}),
                (["--int8_act"], True, {"ternary_matmul_w2a8": 9 * L, **fused})):
            path = os.path.join(root, f"hyp{len(extra)}.tsv")
            _reset(kernels)
            t0 = time.perf_counter()
            with decoded_ids() as record:
                rc = cli.main(["--checkpoint", run, "--split", "test", "--packed", "--out",
                               path, "--device", DEVICE, *extra])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _counts(kernels)
            with open(path) as f:
                rows = [line.rstrip("\n").split("\t") for line in f]
            t = cli.Transcriber(cfg, tree, 2, int8_act, cmvn, DEVICE)
            expect, expect_ids = [], []
            for wb in dm.wav_batches("test", shuffle=False, batch_size=BATCH):
                ids, n = t.transcribe(wb["wavs"], wb["wav_lens"])
                expect_ids += [[int(x) for x in ids[i, : n[i]]] for i in range(len(n))]
                expect += [[u, tok.ids_to_text(ids[i, : n[i]])]
                           for i, u in enumerate(wb["utt_ids"])]
            if rc != 0 or counts != want or rows != expect or record != expect_ids:
                raise AssertionError(f"real data transcribe --split test {extra}: rc={rc} "
                                     f"launches {counts}, want {want}; rows equal to the "
                                     f"data module's order and Transcriber's text: "
                                     f"{rows == expect}, decoded ids equal to Transcriber's: "
                                     f"{record == expect_ids}")
            log(f"real data transcribe --split test --packed {' '.join(extra)}: rc=0 "
                f"launches={counts} utterances={len(rows)} (the manifest's utt_ids in the "
                f"data module's order, the decoded ids equal to Transcriber's, and so the "
                f"text) wall_s={wall:.2f}")
            del t
        dm.close()
        empty = os.path.join(root, "empty")
        os.makedirs(empty)
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = cli.main(["--checkpoint", run, "--split", "test", "--data_dir", empty,
                           "--device", DEVICE])
        if rc != 2 or "no tokenizer artifact" not in err.getvalue():
            raise AssertionError(f"transcribe without a tokenizer: rc={rc}, want 2")
        log("real data transcribe --data_dir <empty>: rc=2 (no tokenizer artifact)")
    log(f"real data: phase wall_s={time.perf_counter() - t_phase:.2f} [{smi}]")


HARD_ALPHABET = "W0123456789"  # the characters of `prepare ingest --hard`'s words
PREP_UTTS, PREP_STEPS = 64, 4  # train utterances; optimizer steps of the options run


@contextlib.contextmanager
def counted_multi_steps():
    """Counts the calls of every step made by train.make_multi_train_step
    for the duration: yields a one-element list."""
    import onebit_asr_tpu_torch.train as train_pkg

    calls, real = [0], train_pkg.make_multi_train_step

    def make(*a, **k):
        multi = real(*a, **k)

        def counting(state, stacked):
            calls[0] += 1
            return multi(state, stacked)
        return counting

    train_pkg.make_multi_train_step = make
    try:
        yield calls
    finally:
        train_pkg.make_multi_train_step = real


def _assert_features_close(what, got, ref):
    """The CPU tests' tolerance of the port's frontend against JAX's (rtol
    1e-4, atol 2e-4) plus one f16 ulp."""
    ref32, got32 = ref.astype(np.float32), got.astype(np.float32)
    err = np.abs(got32 - ref32) - (1e-4 * np.abs(ref32) + np.spacing(np.abs(ref)).astype(
        np.float32))
    log(f"{what}: max |d|={float(np.abs(got32 - ref32).max()):.3g} (tolerance 2e-4 + 1e-4 |x| "
        f"+ 1 f16 ulp; beyond the relative part {float(err.max()):.3g})")
    if got.shape != ref.shape or not (err <= 2e-4).all():
        raise AssertionError(f"{what}: the card's features differ from the CPU's")


def spectrogram_check(data_dir):
    """The spectrogram CLI's [F, T] array on the card against the CPU: the
    synthetic chirp, and the first dev utterance of `data_dir` under its
    cmvn_stats.npz (undone before comparing). Tolerance: the CPU test's
    against JAX (tests/test_torch_spectrogram.py): the FFTs round apart
    relative to each frame's largest bin, which the log magnifies far below
    it (the chirp is a pure tone), so the mel power within 1e-5 of the
    frame's peak everywhere, the log-mel within 2e-4 + 1e-4 |x| in the bins
    within 10 nats of the peak."""
    from onebit_asr_tpu_torch.cli.spectrogram import log_mel

    with np.load(os.path.join(data_dir, "cmvn_stats.npz")) as z:
        mean, std = z["mean"][:, None], z["std"][:, None]
    for what, kw, cmvn in (("chirp", dict(data_dir=os.path.join(data_dir, "no_dir"),
                                          synthetic=True), False),
                           ("dev utterance 0", dict(data_dir=data_dir, split="dev"), True)):
        (got, _), (want, _) = (log_mel(device=d, **kw) for d in (DEVICE, "cpu"))
        if cmvn:
            got, want = got * std + mean, want * std + mean
        peak = want.max(axis=0, keepdims=True)
        d_pow = float(np.abs(np.exp(got - peak) - np.exp(want - peak)).max())
        near = want >= peak - 10.0
        d_log = np.abs(got - want)[near] - 1e-4 * np.abs(want[near])
        log(f"spectrogram {what}{' (CMVN)' if cmvn else ''} [F, T]={list(got.shape)}: card vs "
            f"CPU power max |d|/peak={d_pow:.3g} (tolerance 1e-5), log-mel within 10 nats of "
            f"the peak max |d|={float(np.abs(got - want)[near].max()):.3g} (tolerance 2e-4 + "
            f"1e-4 |x|)")
        if got.shape != want.shape or d_pow > 1e-5 or not (d_log <= 2e-4).all():
            raise AssertionError(f"spectrogram {what}: the card's array differs from the CPU's")


def train_launches(L, steps, evals, branches=3, micro=1, precisions=3, attention=True,
                   subsampler=True):
    """Rows 3-8 of `steps` optimizer steps of `micro` micro-batches of
    `branches` branches and `evals` evaluation batches at `precisions`
    precisions; rows 3-4 only with `attention` (both fused flags set and no
    chunk mask), rows 5-6 only with `subsampler`."""
    n = steps * micro
    want = {"ctc_alpha": n + precisions * evals, "ctc_beta": n}
    if attention:
        want.update(fused_relpos_attention=branches * L * n + precisions * L * evals,
                    fused_relpos_attention_bwd=branches * L * n)
    if subsampler:
        want.update(fused_subsample=branches * n + precisions * evals,
                    fused_subsample_bwd=branches * n)
    return want


def prepare_options_phase(kernels, seed, smi):
    """Step 15: prepare a corpus on the card with the port's `prepare`, and
    train it with the step options; see the module docstring."""
    from onebit_asr_tpu_torch.cli import prepare as pcli
    from onebit_asr_tpu_torch.convert import init_params, qat_model_from_jax
    from onebit_asr_tpu_torch.data.librispeech import LibriSpeechDataModule
    from onebit_asr_tpu_torch.data.text import AsrTokenizer
    from onebit_asr_tpu_torch.train import create_train_state
    from onebit_asr_tpu_torch.train.step import (accumulated_value_and_grad, batch_to_device,
                                                 make_batch_loss, make_fp32_batch_loss,
                                                 sample_sp_mask)
    from onebit_asr_tpu_torch.utils.checkpoint import load_config
    from onebit_asr_tpu_torch.utils.config import DataConfig, LossConfig

    t_phase = time.perf_counter()
    build_root = os.path.join(REPO, "onebit_asr_tpu_torch", "_build")
    os.makedirs(build_root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_root) as root:
        data, cpu = os.path.join(root, "data"), os.path.join(root, "cpu")

        def prepare(*argv, device=DEVICE):
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = pcli.main([*argv, "--device", device])
            lines = "; ".join(out.getvalue().splitlines())
            log(f"prepare {argv[0]} --device {device}: rc={rc} "
                f"{time.perf_counter() - t0:.2f} s: {lines}")
            if rc != 0:
                raise AssertionError(f"prepare {' '.join(argv)} --device {device}: rc={rc}")

        # prepare on the card: the hard corpus, a character tokenizer (the
        # card's machine has no `tokenizers`), token ids, CMVN, the feature
        # cache and the LM; CMVN and features again on the CPU
        prepare("ingest", "--out_dir", data, "--synthetic", str(PREP_UTTS), "--hard",
                "--seed", str(seed))
        write_char_tokenizer(data, HARD_ALPHABET)
        prepare("tokenize", "--out_dir", data)
        shutil.copytree(data, cpu)
        for d, device in ((data, DEVICE), (cpu, "cpu")):
            prepare("cmvn", "--out_dir", d, device=device)
        with np.load(os.path.join(data, "cmvn_stats.npz")) as a, \
                np.load(os.path.join(cpu, "cmvn_stats.npz")) as b:
            for k in ("mean", "std"):
                d = float(np.abs(a[k] - b[k]).max())
                tol = 1e-5 * float(np.abs(b[k]).max())
                log(f"prepare cmvn {k}: card vs CPU max |d|={d:.3g} (tolerance 1e-5 |x| + "
                    f"{tol:.3g})")
                if not (np.abs(a[k] - b[k]) <= 1e-5 * np.abs(b[k]) + tol).all():
                    raise AssertionError(f"prepare cmvn {k}: the card's differs from the CPU's")
        # the CPU's features on the card's statistics: the frontend alone compared
        shutil.copy(os.path.join(data, "cmvn_stats.npz"), cpu)
        for d, device in ((data, DEVICE), (cpu, "cpu")):
            prepare("features", "--out_dir", d, device=device)
        for split in ("train", "dev", "test"):
            name = f"{split}_manifest.jsonl"
            with open(os.path.join(data, name)) as f, open(os.path.join(cpu, name)) as g:
                if f.read() != g.read():
                    raise AssertionError(f"prepare features: {name} differs card vs CPU")
            _assert_features_close(f"prepare features {split} card vs CPU",
                                   np.load(os.path.join(data, f"{split}_feats.npy")),
                                   np.load(os.path.join(cpu, f"{split}_feats.npy")))
        spectrogram_check(data)
        prepare("lm", "--out_dir", data)
        tok = AsrTokenizer.find_and_load(data)

        # train on the prepared dir: Conformer-M under both fused flags,
        # --grad_accum 2 --multistep 2
        L = 12
        argv = ["--data_dir", data, "--preset", "m", "--batch_size", "16", "--num_buckets",
                "2", "--eval_batches", "1", "--fused_attention", "--fused_subsampler",
                "--save_dir", root, "--device", DEVICE, "--epochs", "1"]

        def train(label, extra, want):
            r = train_cli_run(kernels, [*argv, "--run_name", label, *extra], want,
                              f"options train {label}", counted_multi_steps())
            (multi,), metrics = r.watched, r.metrics
            log(f"options train {label} {' '.join(extra)}: rc=0 wall_s={r.wall:.2f} "
                f"multi_step_calls={multi[0]} launches={r.counts} train_loss="
                f"{[round(m['train_loss'], 4) for m in metrics]} host_rss_gb="
                f"{[round(m['host_rss_gb'], 3) for m in metrics]} peak_mem_gb={r.peak_gb:.3f} "
                f"[{smi}]")
            return metrics, r.step_ms, multi[0], r.peak_gb

        metrics, step_ms, n_multi, peak_gb = train(
            "options", ["--grad_accum", "2", "--multistep", "2", "--steps_per_epoch",
                        str(PREP_STEPS)], train_launches(L, PREP_STEPS, 1, micro=2))
        if len(step_ms) != PREP_STEPS or n_multi < 1:
            raise AssertionError(f"options train: {len(step_ms)} timed steps, "
                                 f"{n_multi} K-step calls")
        per_T = {T: [round(ms, 2) for t, ms in step_ms if t == T]
                 for T in sorted({T for T, _ in step_ms})}
        log(f"options train: ms_per_optimizer_step by T {per_T} (2 micro-batches of 8; CUDA "
            f"events around each step, the first of each T a warm-up) peak_mem_gb="
            f"{peak_gb:.3f}; beside step 14 at B=16 in one batch: "
            f"{REAL_TRAIN.get('real', 'not run (--no_real_data)')} [{smi}]")

        # one grad_accum=2 step and one fp32-control step on the kernels
        # against the same step with each kernel pair on its plain version
        run = os.path.join(root, "options")
        cfg = load_config(run).model
        model = qat_model_from_jax(cfg, init_params(cfg, seed), device=DEVICE)
        params = create_train_state(model, seed).params
        dm = LibriSpeechDataModule(data, tok, DataConfig(data_dir=data, batch_size=16,
                                                         num_buckets=2), device=DEVICE)
        batch = batch_to_device(next(dm.featurized_batches("train", 0, augment=True)), DEVICE)
        dm.close()
        sp = sample_sp_mask(torch.Generator().manual_seed(seed + 1), L)
        seeds = [seed + 10 + i for i in range(3)]
        T = batch["feats"].shape[1]
        what_T = f"B=16 T={T} (T'={padded_frames(T, cfg)})"

        def step_(batch_loss):
            (_, aux), grads = accumulated_value_and_grad(batch_loss, params, batch, sp, seeds,
                                                         True, grad_accum=2)
            return {k: float(v) for k, v in aux.items()}, grads

        for kind, batch_loss, want in (
                ("grad_accum=2 QAT step", make_batch_loss(model, LossConfig(), cfg.specials, L),
                 train_launches(L, 1, 0, micro=2)),
                ("grad_accum=2 fp32-control step",
                 make_fp32_batch_loss(model, LossConfig(), cfg.specials),
                 train_launches(L, 1, 0, branches=1, micro=2))):
            held_against_plain(kernels, model, lambda: step_(batch_loss), want,
                               f"options {kind} at {what_T}")
        del model, params

        # the no-QAT control for one short epoch, its first epoch profiled
        prof = os.path.join(root, "profile")
        metrics, _, _, _ = train("fp32", ["--fp32_control", "--steps_per_epoch", "1",
                                          "--profile_dir", prof],
                                 train_launches(L, 1, 1, branches=1, precisions=1))
        tags = {k for k in metrics[0] if k.startswith(("loss_", "wer_", "cer_"))}
        if tags != {"loss_32bit", "wer_32bit", "cer_32bit"}:
            raise AssertionError(f"fp32 control logged {sorted(tags)}")
        trace_path = os.path.join(prof, "trace.json")
        t0 = time.perf_counter()
        with open(trace_path) as f:
            events = json.load(f)["traceEvents"]
        kernel_names = {e["name"] for e in events if e.get("cat") == "kernel"}
        alpha = sorted(n for n in kernel_names if "ctc_alpha" in n)
        log(f"options profile: {trace_path} {os.path.getsize(trace_path) / 1e6:.1f} MB, "
            f"{len(events)} events, {len(kernel_names)} kernel names, row 7 as {alpha} "
            f"(read in {time.perf_counter() - t0:.2f} s)")
        if not alpha:
            raise AssertionError("the --profile_dir trace does not name the CTC alpha kernel")
    wall = time.perf_counter() - t_phase
    log(f"prepare and options: phase wall_s={wall:.2f} (target <= 60) [{smi}]")


OPTION_STEPS = 2  # train steps of each step-16 run


def _options_train(o, name, flags, want):
    """The train CLI in process: 2 steps at B=16, 1,024 frames (T'=256) and
    one evaluation batch at 32/2/1; its launches, ms per step and peak
    memory; -> (run dir, config, JAX-layout tree)."""
    from onebit_asr_tpu_torch.convert import jax_tree_from_state_dict
    from onebit_asr_tpu_torch.utils.checkpoint import load_config, restore_params

    r = train_cli_run(o.kernels, ["--dummy_data", "--dummy_frames", "1024", "--batch_size", "16",
                                  "--epochs", "1", "--steps_per_epoch", str(OPTION_STEPS),
                                  "--eval_batches", "1", "--save_dir", o.root, "--run_name",
                                  name, "--device", DEVICE, *flags], want, f"options {name}")
    metrics = r.metrics[0]
    losses = [metrics[k] for k in ("train_loss", "loss_32bit", "loss_2bit", "loss_1bit")]
    if len(r.step_ms) != OPTION_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"options {name}: {len(r.step_ms)} steps; losses {losses}")
    log(f"options {name} ({' '.join(flags)}): rc=0 wall_s={r.wall:.2f} launches={r.counts} "
        f"ms_per_step={[round(ms, 2) for _, ms in r.step_ms]} (CUDA events; the first a "
        f"warm-up) peak_mem_gb={r.peak_gb:.3f} train_loss={metrics['train_loss']:.5g} "
        f"loss_32/2/1bit={'/'.join(f'{v:.5g}' for v in losses[1:])}; beside step 7 (B=16, "
        f"T'=256): { {k: round(v, 2) for k, v in STEP_MS.items()} } [{o.smi}]")
    cfg = load_config(r.run)
    _, sd = restore_params(os.path.join(r.run, "ckpt"))
    return r.run, cfg, jax_tree_from_state_dict(sd, cfg.model)


def _options_transcribe(o, what, run, extra, want):
    from onebit_asr_tpu_torch.cli import transcribe as cli

    out = os.path.join(o.root, "hyp.tsv")
    _reset(o.kernels)
    t0 = time.perf_counter()
    rc = cli.main(["--checkpoint", run, "--wav_dir", o.wav_dir, "--data_dir", o.data,
                   "--batch_size", str(BATCH), "--out", out, "--device", DEVICE, *extra])
    torch.cuda.synchronize()
    got = _counts(o.kernels)
    if rc != 0 or got != want or len(_hyps(out)) != BATCH:
        raise AssertionError(f"options {what}: rc={rc} launches {got}, want {want}")
    log(f"options {what}: transcribe --checkpoint {' '.join(extra)}: rc=0 "
        f"launches_per_batch={got} utterances={BATCH} wall_s={time.perf_counter() - t0:.2f}")


def _options_evaluate(o, what, run, extra, want):
    """The evaluate CLI on one synthetic batch, greedy: {tag: loss}."""
    from onebit_asr_tpu_torch.cli import evaluate as ecli

    _reset(o.kernels)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = ecli.main(["--checkpoint", run, "--dummy_data", "--max_batches", "1", "--greedy",
                        "--device", DEVICE, *extra])
    got, text = _counts(o.kernels), out.getvalue()
    for line in text.splitlines():
        log(f"options {what} eval {' '.join(extra)}: {line}")
    losses = {}
    for line in text.splitlines():  # "    2bit: loss 3.456  WER ..."
        if ": loss " in line:
            tag, rest = line.split(": loss ")
            losses[tag.strip()] = float(rest.split()[0])
    if rc != 0 or got != want or not losses or not np.isfinite(list(losses.values())).all():
        raise AssertionError(f"options {what} eval {extra}: rc={rc} launches {got}, want "
                             f"{want}; losses {losses}")
    log(f"options {what} eval {' '.join(extra)}: rc=0 launches={got} losses={losses}")
    return losses


def _options_stream(o, L=12):
    """(a) the streaming encoder under both fused flags: the chunk mask keeps
    rows 3-4 off; then packed serving against the plain path. -> (run dir,
    config, JAX-layout tree) for step 17."""
    from onebit_asr_tpu_torch.cli import transcribe as cli

    flags = ["--conv_norm", "layer_norm", "--causal_conv", "--attn_chunk_size", "16",
             "--attn_left_chunks", "2", "--fused_attention", "--fused_subsampler"]
    run, cfg, tree = _options_train(o, "stream", flags,
                                    train_launches(L, OPTION_STEPS, 1, attention=False))
    log("options stream: rows 3-4 launched 0 times although fused_attention is set: JAX "
        "takes its XLA attention whenever a pair mask is set (onebit_asr_tpu/model/"
        "conformer.py:310-316), and the port takes its plain chain there too (the fused "
        "kernel has no pair mask); rows 5-8 as step 8 counts them")
    for what, extra, int8_act, row in (("stream packed p2", [], False, "ternary_matmul_bf16"),
                                        ("stream packed int8", ["--int8_act"], True,
                                         "ternary_matmul_w2a8")):
        _options_transcribe(o, what, run, ["--packed", *extra], {row: 9 * L, "fused_subsample": 1})
        t = cli.Transcriber(cfg, tree, 2, int8_act, o.cmvn, DEVICE)
        lp, enc_lens = t.log_probs(o.batch, o.lens)
        _use_plain(t.model, int8_act)
        lp_ref, _ = t.log_probs(o.batch, o.lens)
        mask, dmax, dmean, agree = _compare(what, lp, lp_ref, enc_lens, cfg.model.vocab_size,
                                            cfg.model.time_pad_multiple)
        log(f"options {what}: T'={lp.shape[1]} ({lp.shape[1] // 16} chunks of 16, 2 left) "
            f"valid_frames={int(mask.sum())} vs the plain path: logprob max|d|={dmax:.4g} "
            f"mean|d|={dmean:.4g} argmax_agree={agree:.4f} (tolerance mean <= 0.05, "
            f"agreement >= 0.9)")
        if dmean > 0.05 or agree < 0.9:
            raise AssertionError(f"options {what}: kernel path strays from the plain path")
        del t
    return run, cfg, tree


def _options_decoder(o, L=12):
    """(b) the quantized reference decoder with group norm under both fused
    flags: one step against the plain versions; the packed model's decoder
    and CTC log-probs on rows 1 and 2 against their plain versions; then
    packed evaluation (128 row-1 launches) against the unpacked loss."""
    from onebit_asr_tpu_torch.convert import (init_params, packed_model_from_jax,
                                              qat_model_from_jax)
    from onebit_asr_tpu_torch.losses.attention import make_att_targets
    from onebit_asr_tpu_torch.model.asr import precision_to_binary_mask
    from onebit_asr_tpu_torch.train import create_train_state
    from onebit_asr_tpu_torch.train.step import make_batch_loss, sample_sp_mask, value_and_grad

    flags = ["--quant_decoder", "--reference_decoder", "--conv_norm", "group_norm",
             "--fused_attention", "--fused_subsampler"]
    run, cfg, tree = _options_train(o, "decoder", flags, train_launches(L, OPTION_STEPS, 1))
    if not cfg.loss.reference_smoothing:
        raise AssertionError("--reference_decoder did not set LossConfig.reference_smoothing")
    model = qat_model_from_jax(cfg.model, init_params(cfg.model, o.seed), device=DEVICE)
    params = create_train_state(model, o.seed).params
    batch = bench_batch(cfg.model, o.seed)
    batch_loss = make_batch_loss(model, cfg.loss, cfg.model.specials, L)
    sp = sample_sp_mask(torch.Generator().manual_seed(o.seed + 1), L)

    def step_():
        gens = [torch.Generator(device=DEVICE).manual_seed(o.seed + i) for i in range(3)]
        (_, aux), grads = value_and_grad(batch_loss, params, batch, sp, gens)
        return {k: float(v) for k, v in aux.items()}, grads

    held_against_plain(o.kernels, model, step_, train_launches(L, 1, 0),
                       "options decoder step at B=16 T=1024 (T'=256)")
    del model, params

    # the trained run packed with its decoder: rows 1-2 at the decoder's own
    # shapes, M = B(U+1) = 784 rows for the self-attention, ff and
    # cross-attention query projections, the encoder's B T' = 4096 for the
    # cross-attention's keys and values
    tgt_inp, _, tgt_valid = make_att_targets(batch["tokens"], batch["token_lens"],
                                             cfg.model.specials)
    bm = precision_to_binary_mask(2, L).to(DEVICE)
    for int8_act, row in ((False, "ternary_matmul_bf16"), (True, "ternary_matmul_w2a8")):
        packed_model = packed_model_from_jax(cfg.model, tree, 2, int8_act, DEVICE, decoder=True)

        def forward():
            with torch.no_grad():
                _, enc_mask, logits_ctc, dec_logits = packed_model.forward_with_decoder(
                    batch["feats"], batch["feat_lens"], tgt_inp, tgt_valid, bm)
            return {"CTC": (torch.log_softmax(logits_ctc.float(), -1), enc_mask),
                    "decoder": (torch.log_softmax(dec_logits.float(), -1), tgt_valid)}

        out, got = launched(o.kernels, forward)
        want = {row: 9 * L + 2 * 10, "fused_subsample": 1, "fused_relpos_attention": L}
        if got != want:
            raise AssertionError(f"options decoder packed forward: launches {got}, want {want}")
        _use_plain(packed_model, int8_act)
        ref, got_p = launched(o.kernels, forward)
        if got_p:
            raise AssertionError(f"options decoder packed forward: the plain path launched {got_p}")
        for what, (lp, mask) in out.items():
            lp_ref = ref[what][0]
            if not bool(torch.isfinite(lp[mask]).all()):
                raise AssertionError(f"options decoder packed {what}: non-finite log-probs")
            d = (lp - lp_ref).abs()[mask]
            agree = (lp.argmax(-1) == lp_ref.argmax(-1))[mask].float().mean().item()
            log(f"options decoder packed p2{' int8_act' if int8_act else ''} {what} log-probs "
                f"{tuple(lp.shape)} ({int(mask.sum())} valid positions) vs the plain path: "
                f"max|d|={d.max().item():.4g} mean|d|={d.mean().item():.4g} "
                f"argmax_agree={agree:.4f} (tolerance mean <= 0.05, agreement >= 0.9) "
                f"launches={got}")
            if d.mean().item() > 0.05 or agree < 0.9:
                raise AssertionError(f"options decoder packed {what}: the kernels stray from "
                                     f"the plain path")
        del packed_model, out, ref
    # packed: 9 x 12 encoder projections and 2 x (4 + 4 + 2) decoder ones
    fwd = {"ctc_alpha": 1, "fused_subsample": 1, "fused_relpos_attention": L}
    packed = _options_evaluate(o, "decoder", run, ["--packed", "--precisions", "2"],
                               {**fwd, "ternary_matmul_bf16": 9 * L + 2 * 10})
    unpacked = _options_evaluate(o, "decoder", run, ["--precisions", "2"], fwd)
    d = abs(packed["2bit"] - unpacked["2bit"])
    log(f"options decoder eval: packed vs unpacked precision-2 loss {packed['2bit']:.4g} / "
        f"{unpacked['2bit']:.4g}, |d|={d:.3g} (tolerance 0.02 x the unpacked loss + 0.002: "
        f"the unpacked product rounds alpha * Q to bf16, 2^-9 relative, the packed one "
        f"scales in f32; the CLI prints 3 decimals)")
    if d > 0.02 * abs(unpacked["2bit"]) + 0.002:
        raise AssertionError("options decoder eval: the packed loss strays from the unpacked")


def _options_per_channel(o, L=12):
    """(c) per-channel alpha, unfused: evaluated at 32/2/1 and served
    unpacked; the packed export refuses it, as JAX's does."""
    from onebit_asr_tpu_torch.cli import transcribe as cli

    run, _, _ = _options_train(o, "per_channel", ["--quant_per_channel"],
                               train_launches(L, OPTION_STEPS, 1, attention=False,
                                              subsampler=False))
    _options_evaluate(o, "per_channel", run, [], {"ctc_alpha": 3})
    _options_transcribe(o, "per_channel unpacked p2", run, [], {})
    try:
        cli.main(["--checkpoint", run, "--wav_dir", o.wav_dir, "--data_dir", o.data,
                  "--out", os.path.join(o.root, "hyp.tsv"), "--device", DEVICE, "--packed"])
    except NotImplementedError as e:
        if "tensor-wise alpha" not in str(e):
            raise
        log(f"options per_channel transcribe --packed: refused as JAX's export refuses it: "
            f"NotImplementedError: {e}")
    else:
        raise AssertionError("transcribe --packed served a per-channel run")


@contextlib.contextmanager
def options_inputs(kernels, seed, smi):
    """What step 16's parts share: a temporary root under the build dir with
    step 3's 8 waveforms as wavs, their CMVN and a character tokenizer."""
    from types import SimpleNamespace

    build_root = os.path.join(REPO, "onebit_asr_tpu_torch", "_build")
    os.makedirs(build_root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_root) as root:
        wavs = synthetic_waveforms(seed)
        batch, lens = pcm_batch(wavs)
        o = SimpleNamespace(kernels=kernels, seed=seed, smi=smi, root=root, batch=batch,
                            lens=lens, cmvn=cmvn_of(batch, lens),
                            wav_dir=os.path.join(root, "wavs"), data=os.path.join(root, "data"))
        write_wavs(o.wav_dir, wavs)
        write_cmvn(o.data, o.cmvn)
        write_char_tokenizer(o.data)
        yield o


def model_options_phase(kernels, seed, smi):
    """Step 16: Conformer-M trained, evaluated and served under the model
    options: (a) the streaming encoder (layer norm, causal conv, chunked
    attention), (b) the quantized reference decoder with group norm, (c)
    per-channel alpha; see the module docstring. Step 17 (the streaming
    runtime) runs on (a)'s run right after (a). -> step 17's chunk steps
    [(label, fn)], whose device kernels are counted at the end."""
    t_phase = time.perf_counter()
    with options_inputs(kernels, seed, smi) as o:
        stream = _options_stream(o)
        log(f"model options: (a) wall_s={time.perf_counter() - t_phase:.2f}")
        chunk_steps = streaming_phase(o, *stream)
        del stream
        t_rest = time.perf_counter()
        _options_decoder(o)
        _options_per_channel(o)
    log(f"model options: phase wall_s={time.perf_counter() - t_phase:.2f}, (b) and (c) "
        f"{time.perf_counter() - t_rest:.2f} [{smi}]")
    return chunk_steps


STREAM_PUSH = 10  # feature frames a push in step 17: 100 ms of audio
# the streaming daemon as a subprocess that reports, on exit, the launches of
# every kernel wrapper in its process
DAEMON = """import atexit, runpy, sys
from onebit_asr_tpu_torch.ops import attention as fa, ctc_lattice as cl
from onebit_asr_tpu_torch.ops import subsampler as ss, ternary_matmul as tm
fns = (tm.ternary_matmul, tm.ternary_matmul_w2a8, ss.fused_subsample, ss.fused_subsample_bwd,
       fa.fused_relpos_attention, fa.fused_relpos_attention_bwd, cl.ctc_alpha, cl.ctc_beta)
atexit.register(lambda: print("kernel launches", sum(f.launches for f in fns), file=sys.stderr))
sys.argv = ["onebit_asr_tpu_torch.serve", *sys.argv[1:]]
runpy.run_module("onebit_asr_tpu_torch.serve", run_name="__main__")
"""


def _recording(rt):
    """Wrap a session's or server's `_step` to record (f32 logits [N, cs,
    V], cur_valid [N]) of every chunk step, on the card."""
    record, step = [], rt._step

    def wrapped(windows, caches, cache_valid, cur_valid):
        logits, new_caches = step(windows, caches, cache_valid, cur_valid)
        record.append((logits, cur_valid))
        return logits, new_caches

    rt._step = wrapped
    return record


def _held(what, lps, refs, ids, ref_ids):
    """Log-probs of each utterance on its valid frames against a reference's:
    max and mean |d|, argmax agreement, the share of utterances whose ids are
    equal; step 3's tolerances."""
    d = torch.cat([(a - b).abs().flatten() for a, b in zip(lps, refs)])
    agree = torch.cat([a.argmax(-1) == b.argmax(-1) for a, b in zip(lps, refs)]).float().mean()
    same = sum(a == b for a, b in zip(ids, ref_ids))
    finite = all(bool(torch.isfinite(a).all()) for a in lps)
    log(f"streaming {what}: valid_frames={sum(len(a) for a in lps)} logprob "
        f"max|d|={d.max().item():.4g} mean|d|={d.mean().item():.4g} "
        f"argmax_agree={agree.item():.4f} same_ids={same}/{len(ids)} (tolerance mean <= 0.05, "
        f"agreement >= 0.9)")
    if not finite or d.mean().item() > 0.05 or agree.item() < 0.9:
        raise AssertionError(f"streaming {what}: strays from its reference")


def streaming_phase(o, run, cfg, tree):
    """Step 17: the streaming runtime on step 16 (a)'s run (vocabulary 32,
    chunks of 16 with 2 left) over step 3's 8 waveforms, featurized one by
    one on the card as the daemon does; see the module docstring. ->
    [(label, one chunk step at N=1 / N=8)]."""
    from onebit_asr_tpu_torch.cli import evaluate as ecli
    from onebit_asr_tpu_torch.cli import serve as serve_cli
    from onebit_asr_tpu_torch.convert import qat_model_from_jax
    from onebit_asr_tpu_torch.decode.greedy import greedy_ctc_decode
    from onebit_asr_tpu_torch.decode.streaming import (StreamingServer, StreamingSession,
                                                       streaming_modules)
    from onebit_asr_tpu_torch.model.asr import precision_to_binary_mask

    t_phase = time.perf_counter()
    mc = cfg.model
    cs, L = mc.attn_chunk_size, mc.enc_layers
    featurize = serve_cli.wav_featurizer(cfg.frontend, o.cmvn, DEVICE)
    wavs = [os.path.join(o.wav_dir, f"utt{i}.wav") for i in range(BATCH)]
    feats = [featurize(w) for w in wavs]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    modules = streaming_modules(mc, tree, DEVICE)

    # (i) one session per utterance, in pushes of 10 frames
    _reset(o.kernels)
    sess_lp, sess_ids, chunks = [], [], 0
    t0 = time.perf_counter()
    for f in feats:
        sess = StreamingSession(mc, None, 2, DEVICE, modules)
        record = _recording(sess)
        ids = []
        for k in range(0, len(f), STREAM_PUSH):
            ids += sess.accept(f[k: k + STREAM_PUSH])
        ids += sess.finish()
        sess_ids.append(ids)
        sess_lp.append(torch.log_softmax(
            torch.cat([lg[0, : int(n[0])] for lg, n in record]), -1))
        chunks += len(record)
    torch.cuda.synchronize()
    wall_sessions = time.perf_counter() - t0
    launched_i = _counts(o.kernels)
    log(f"streaming (i) sessions: {BATCH} utterances, {chunks} chunk steps, pushes of "
        f"{STREAM_PUSH} frames, wall_s={wall_sessions:.2f} ({wall_sessions / chunks * 1e3:.2f} ms "
        f"a chunk with the host's work) kernel launches={launched_i}")

    # the same run's offline chunked encoder, fused flags cleared
    model = qat_model_from_jax(dataclasses.replace(mc, fused_subsampler=False,
                                                   fused_attention=False),
                               tree, DEVICE, decoder=False).requires_grad_(False).eval()
    lens = torch.tensor([len(f) for f in feats], device=DEVICE)
    x = torch.zeros(BATCH, int(lens.max()), mc.input_dim, device=DEVICE)
    for i, f in enumerate(feats):
        x[i, : len(f)] = torch.from_numpy(f)
    with torch.no_grad():
        _, mask, logits = model(x, lens, precision_to_binary_mask(2, L).to(DEVICE))
    off = torch.log_softmax(logits.float(), -1)
    n_valid = mask.sum(-1)
    off_ids, off_n = greedy_ctc_decode(off, n_valid, mc.specials.blank_id)
    off_ids = [off_ids[i, : int(off_n[i])].tolist() for i in range(BATCH)]
    refs = [off[i, : int(n_valid[i])] for i in range(BATCH)]
    if [len(a) for a in sess_lp] != [len(r) for r in refs]:
        raise AssertionError(f"streaming (i): frames {[len(a) for a in sess_lp]} vs offline "
                             f"{[len(r) for r in refs]}")
    _held("(i) sessions vs the offline chunked encoder", sess_lp, refs, sess_ids, off_ids)
    del model, x, logits, off, refs

    # (ii) one server of 8 slots over all 8 utterances
    _reset(o.kernels)
    server = StreamingServer(mc, None, 2, max_streams=BATCH, device=DEVICE, modules=modules)
    record = _recording(server)
    srv_ids = {}
    t0 = time.perf_counter()
    for f in feats:
        sid = server.open()
        server.feed(sid, f)
        server.close(sid)
        srv_ids[sid] = []
    while any(server._open):
        for sid, toks in server.step().items():
            srv_ids[sid] += toks
    torch.cuda.synchronize()
    wall_server = time.perf_counter() - t0
    launched_ii = _counts(o.kernels)
    srv_ids = [srv_ids[i] for i in range(BATCH)]
    srv_lp = [torch.log_softmax(torch.cat([lg[i, : int(n[i])] for lg, n in record
                                           if int(n[i])]), -1) for i in range(BATCH)]
    log(f"streaming (ii) server: {len(record)} batched steps of {BATCH} slots, "
        f"wall_s={wall_server:.2f} kernel launches={launched_ii}")
    _held("(ii) server vs (i) sessions", srv_lp, sess_lp, srv_ids, sess_ids)
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9

    # (iii) the daemon on stdio, default device
    lines = ([{"op": "open"}] * BATCH + [{"op": "feed_wav", "sid": i, "path": w}
                                          for i, w in enumerate(wavs)]
             + [{"op": "close", "sid": i} for i in range(BATCH)])
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", DAEMON, "--checkpoint", run, "--data_dir", o.data,
         "--max_streams", str(BATCH), *([] if DEVICE == "cuda" else ["--device", DEVICE])],
        input="".join(json.dumps(x) + "\n" for x in lines), capture_output=True, text=True,
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO}, timeout=300)
    wall_daemon = time.perf_counter() - t0
    events = [json.loads(line) for line in proc.stdout.splitlines()]
    finals = {e["sid"]: e["ids"] for e in events if e["event"] == "final"}
    errors = [e for e in events if e["event"] == "error"]
    launched_iii = [line for line in proc.stderr.splitlines() if line.startswith("kernel launches")]
    texts = sum("text" in e for e in events)
    log(f"streaming (iii) daemon: rc={proc.returncode} wall_s={wall_daemon:.2f} (start-up, "
        f"restore and featurizing included) events={len(events)} finals={len(finals)} "
        f"with_text={texts} errors={errors} {launched_iii}")
    if (proc.returncode != 0 or errors or launched_iii != ["kernel launches 0"]
            or [finals.get(i) for i in range(BATCH)] != srv_ids):
        raise AssertionError(f"streaming (iii): the daemon's finals differ from (ii)'s ids or "
                             f"it failed: {proc.stderr[-2000:]}")
    log("streaming (iii): the daemon's finals equal (ii)'s ids for all 8 streams")
    if launched_i or launched_ii:
        raise AssertionError(f"streaming: kernel rows launched in (i) {launched_i} or (ii) "
                             f"{launched_ii}")

    # (iv) evaluate --streaming
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = ecli.main(["--checkpoint", run, "--dummy_data", "--streaming", "--max_batches", "1",
                        "--device", DEVICE])
    for line in out.getvalue().splitlines():
        log(f"streaming (iv) evaluate --streaming: {line}")
    if rc != 0 or "streaming) ==" not in out.getvalue():
        raise AssertionError(f"streaming (iv): evaluate --streaming rc={rc}")
    log(f"streaming (iv): rc=0 wall_s={time.perf_counter() - t0:.2f}")

    # one chunk step on the card, full caches (the 6th window of utterance 0)
    sess = StreamingSession(mc, None, 2, DEVICE, modules)
    start = 5 * sess.hop_raw
    sess.accept(feats[0][:start + 3])
    full = torch.tensor([sess.cache_chunks * cs], device=DEVICE)
    win1 = torch.from_numpy(feats[0][start: start + sess.window_raw][None]).to(DEVICE)
    args1 = (win1, sess._caches, full, torch.tensor([cs], device=DEVICE))
    args8 = (win1.expand(BATCH, -1, -1).contiguous(),
             sess._caches.expand(-1, BATCH, -1, -1).contiguous(), full.expand(BATCH).contiguous(),
             torch.full((BATCH,), cs, device=DEVICE))
    server = StreamingServer(mc, None, 2, max_streams=BATCH, device=DEVICE, modules=modules)
    step1, step8 = (lambda: sess._step(*args1)), (lambda: server._step(*args8))
    audio_ms = cs * 40.0
    ms = {}
    for n, fn in ((1, step1), (BATCH, step8)):
        ms[n] = cuda_ms(fn, iters=20, warmup=3)
    log(f"streaming chunk step (d={mc.enc_d_model}, {L} blocks, window {sess.cache_chunks * cs} "
        f"cached + "
        f"{cs} frames, precision 2, CUDA events): N=1 {ms[1]:.3f} ms, N=8 {ms[BATCH]:.3f} ms; "
        f"real-time factor per stream {ms[1] / audio_ms:.4f} (N=1), {ms[BATCH] / audio_ms:.4f} "
        f"(N=8; a chunk is {audio_ms:.0f} ms of audio); peak_mem_gb={peak_gb:.3f} (above the "
        f"phase's start); kernel rows launched 0 in (i)-(iii); device kernels per chunk step at "
        f"the end (torch.profiler)")
    export_stream_part(o, run, cfg, lines, srv_ids, args8, ms[BATCH])
    log(f"streaming: step 17 wall_s={time.perf_counter() - t_phase:.2f} [{o.smi}]")
    return [("streaming chunk step N=1", step1), (f"streaming chunk step N={BATCH}", step8)]


def export_stream_part(o, run, cfg, lines, srv_ids, args8, live_ms):
    """Step 19 (f): step 17's run exported as an 8-slot streaming artifact
    through the export CLI and served by `serve --artifact` (a subprocess on
    stdio, step 17's NDJSON): its finals must equal step 17 (ii)'s server
    ids for all 8 streams; one artifact chunk step at N=8 is timed beside
    the live step (`live_ms`)."""
    from onebit_asr_tpu_torch.cli import export as export_cli
    from onebit_asr_tpu_torch.export import load_artifact
    from onebit_asr_tpu_torch.utils.config import FrontendConfig

    t_part = time.perf_counter()
    art = os.path.join(o.root, "stream8.export")
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = export_cli.main(["streaming", "--checkpoint", run, "--out", art, "--n_streams",
                              str(BATCH)])
    export_s = time.perf_counter() - t0
    mb = os.path.getsize(os.path.join(art, "module.pt2")) / 1e6
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", DAEMON, "--artifact", art, "--data_dir", o.data],
        input="".join(json.dumps(x) + "\n" for x in lines), capture_output=True, text=True,
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO}, timeout=300)
    wall_daemon = time.perf_counter() - t0
    events = [json.loads(line) for line in proc.stdout.splitlines()]
    finals = {e["sid"]: e["ids"] for e in events if e["event"] == "final"}
    errors = [e for e in events if e["event"] == "error"]
    launched = [line for line in proc.stderr.splitlines() if line.startswith("kernel launches")]
    fn, _ = load_artifact(art)
    active = torch.ones(BATCH, dtype=torch.bool, device=DEVICE)
    ms_a = cuda_ms(lambda: fn(*args8, active), iters=20, warmup=3)
    log(f"export (f) streaming, {BATCH} slots, precision 2: export CLI rc={rc} "
        f"export+save_s={export_s:.2f} module_mb={mb:.2f}; serve --artifact rc={proc.returncode} "
        f"wall_s={wall_daemon:.2f} (start-up, load and featurizing included) finals="
        f"{len(finals)} errors={errors} {launched}; the run's frontend is the default one: "
        f"{cfg.frontend == FrontendConfig()}; ms per chunk step at N={BATCH} artifact={ms_a:.3f} "
        f"live={live_ms:.3f}; part wall_s={time.perf_counter() - t_part:.2f} [{o.smi}]")
    if (rc != 0 or proc.returncode != 0 or errors or launched != ["kernel launches 0"]
            or [finals.get(i) for i in range(BATCH)] != srv_ids):
        raise AssertionError(f"export (f): serve --artifact's finals differ from step 17 (ii)'s "
                             f"ids, or it failed: {proc.stderr[-2000:]}")
    log("export (f): serve --artifact's finals equal step 17 (ii)'s server ids for all 8 streams")


def reference_checkpoint_phase(kernels, seed, smi):
    """Step 18: a Conformer-M reference-layout checkpoint drawn from `seed`
    (`reference_state_dict`, with a sibling config.json) through `evaluate
    --torch_checkpoint` unpacked, packed and packed with --int8_act; the
    packed f32 model on rows 1 and 2 against the plain path on step 3's 8
    waveforms; see the module docstring."""
    from onebit_asr_tpu_torch.cli import evaluate as ecli
    from onebit_asr_tpu_torch.convert import (flatten, init_params, packed_model_from_jax,
                                              qat_model_from_jax)
    from onebit_asr_tpu_torch.model.asr import precision_to_binary_mask
    from onebit_asr_tpu_torch.model.presets import apply_preset
    from onebit_asr_tpu_torch.ops.frontend import LogMelFrontend, apply_cmvn
    from onebit_asr_tpu_torch.utils.config import ModelConfig
    from onebit_asr_tpu_torch.utils.torch_import import load_reference_checkpoint_params

    t_phase = time.perf_counter()
    mc = dataclasses.replace(apply_preset(ModelConfig(), "m"), compute_dtype="float32",
                             conv_norm="batch_norm")
    L = mc.enc_layers
    build_root = os.path.join(REPO, "onebit_asr_tpu_torch", "_build")
    os.makedirs(build_root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_root) as root:
        t0 = time.perf_counter()
        tree = init_params(mc, seed)
        sd = reference_state_dict(tree, seed)
        path = os.path.join(root, "ckpt_last.pt")
        torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()},
                    "args": {"gamma_ctc": 0.2}}, path)
        with open(os.path.join(root, "config.json"), "w") as f:
            json.dump({k: getattr(mc, k) for k in ecli.REFERENCE_HPARAMS}, f)
        log(f"reference: wrote {os.path.getsize(path) / 1e6:.1f} MB ({len(sd)} tensors, "
            f"d={mc.enc_d_model}, {L} blocks, {mc.dec_layers} decoder layers, vocabulary "
            f"{mc.vocab_size}) in "
            f"{time.perf_counter() - t0:.2f} s")
        imported = load_reference_checkpoint_params(path, mc.input_dim, L, mc.dec_layers)
        flat, want = flatten(imported), flatten(tree)
        if sorted(flat) != sorted(want) or not all(np.array_equal(flat[k], want[k]) for k in want):
            raise AssertionError("reference: the import does not give back the drawn tree")
        fwd = {"ctc_alpha": 1}
        for extra, launches in (([], {"ctc_alpha": 3}),
                                (["--packed"], {**fwd, "ternary_matmul_bf16": 9 * L}),
                                (["--packed", "--int8_act"], {**fwd, "ternary_matmul_w2a8": 9 * L})):
            _reset(kernels)
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = ecli.main(["--torch_checkpoint", path, "--dummy_data", "--greedy",
                                "--max_batches", "1", "--precisions", "32,2,1", "--device", DEVICE,
                                *extra])
            torch.cuda.synchronize()
            got, text = _counts(kernels), out.getvalue()
            losses = [float(line.split("loss ")[1].split()[0]) for line in text.splitlines()
                      if ": loss " in line]
            for line in text.splitlines():
                log(f"reference evaluate --torch_checkpoint {' '.join(extra)}: {line}")
            if rc != 0 or got != launches or not losses or not np.isfinite(losses).all():
                raise AssertionError(f"reference {extra}: rc={rc} launches {got}, want "
                                     f"{launches}; losses {losses}")
            log(f"reference {' '.join(extra) or 'unpacked'}: rc=0 launches={got} "
                f"wall_s={time.perf_counter() - t0:.2f} (one dummy batch, B=16, T=160, at "
                f"{len(losses)} precision(s))")

    # the packed f32 model on the 8 waveforms: kernels vs plain, ms per batch
    batch, lens = pcm_batch(synthetic_waveforms(seed))
    cmvn = [torch.from_numpy(a).to(DEVICE) for a in cmvn_of(batch, lens)]
    feats, feat_lens = LogMelFrontend()(torch.from_numpy(batch).to(DEVICE),
                                        torch.from_numpy(lens).to(DEVICE))
    feats = apply_cmvn(feats, *cmvn)
    qat = qat_model_from_jax(mc, imported, DEVICE, decoder=False).requires_grad_(False).eval()
    bm = precision_to_binary_mask(2, L).to(DEVICE)
    with torch.no_grad():
        plain_ms = cuda_ms(lambda: qat(feats, feat_lens, bm), iters=5, warmup=1)
    del qat
    for int8_act, row in ((False, "ternary_matmul_bf16"), (True, "ternary_matmul_w2a8")):
        model = packed_model_from_jax(mc, imported, 2, int8_act, DEVICE)

        def forward(model=model):
            with torch.no_grad():
                _, enc_mask, logits = model(feats, feat_lens)
            return torch.log_softmax(logits.float(), -1), enc_mask.sum(-1)

        (lp, enc_lens), got = launched(kernels, forward)
        if got != {row: 9 * L}:
            raise AssertionError(f"reference packed forward: launches {got}, want {row}: {9 * L}")
        ms = cuda_ms(forward, iters=5, warmup=1)
        _use_plain(model, int8_act)
        (lp_ref, _), got_p = launched(kernels, forward)
        if got_p:
            raise AssertionError(f"reference packed forward: the plain path launched {got_p}")
        _, dmax, dmean, agree = _compare(f"reference {row}", lp, lp_ref, enc_lens, mc.vocab_size,
                                         mc.time_pad_multiple)
        log(f"reference packed f32 {row}: T'={lp.shape[1]} launches={got} vs the plain path: "
            f"logprob max|d|={dmax:.4g} mean|d|={dmean:.4g} argmax_agree={agree:.4f} (tolerance "
            f"mean <= 0.05, agreement >= 0.9); ms_per_batch={ms:.2f} (CUDA events, B=8, "
            f"{lens.sum() / SAMPLE_RATE:.2f} s of audio; the unpacked f32 QAT forward at "
            f"precision 2: {plain_ms:.2f})")
        if dmean > 0.05 or agree < 0.9:
            raise AssertionError(f"reference packed {row}: the kernels stray from the plain path")
        del model
    log(f"reference: step 18 wall_s={time.perf_counter() - t_phase:.2f} (target < 60) [{smi}]")


def reference_state_dict(tree, seed=0):
    """A JAX-layout tree (batch-norm conv module, tensor-wise alpha, a
    full-precision decoder) -> the reference PyTorch model's state dict, as
    numpy: the inverse of utils/torch_import.py, with the key names it reads
    (Linear [out, in], Conv2d OIHW, pointwise Conv1d [out, in, 1], the
    depthwise [D, 1, k], the subsampler projection's columns c*F'+f, the
    decoder's fused q/k/v in_proj). It also writes what a reference
    checkpoint carries and the import does not read: each depthwise conv's
    bias and each BatchNorm's running statistics, drawn from `seed`."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    sd = {}

    def put(key, v):
        sd[key] = np.ascontiguousarray(np.asarray(v, f32))

    def ln(prefix, node):  # the reference wraps nn.LayerNorm as `.ln`
        put(f"{prefix}.ln.weight", node["scale"])
        put(f"{prefix}.ln.bias", node["bias"])

    def linear(prefix, node):
        put(f"{prefix}.weight", np.asarray(node["kernel"]).T)
        if "alpha" in node:
            put(f"{prefix}.alpha", node["alpha"])
        if "bias" in node:
            put(f"{prefix}.bias", node["bias"])

    enc = tree["encoder"]
    sub = enc["subsample"]
    for name, ref in (("conv1", "conv.0"), ("conv2", "conv.2")):
        put(f"encoder.subsample.{ref}.weight", np.asarray(sub[name]["kernel"]).transpose(3, 2, 0, 1))
        put(f"encoder.subsample.{ref}.bias", sub[name]["bias"])
    kern = np.asarray(sub["proj"]["kernel"])  # rows f*C+c
    C, d = np.asarray(sub["conv2"]["kernel"]).shape[-1], kern.shape[1]
    put("encoder.subsample.out.weight",
        kern.reshape(-1, C, d).transpose(2, 1, 0).reshape(d, -1))  # columns c*F'+f
    put("encoder.subsample.out.bias", sub["proj"]["bias"])
    blocks = enc["blocks"]
    L = np.asarray(blocks["ln_out"]["scale"]).shape[0]
    for i in range(L):
        b = _layer(blocks, i)
        p = f"encoder.blocks.{i}"
        for ff in ("ff1", "ff2"):
            ln(f"{p}.{ff}.ln", b[ff]["ln"])
            linear(f"{p}.{ff}.lin1", b[ff]["w1"])
            linear(f"{p}.{ff}.lin2", b[ff]["w2"])
        m = b["mhsa"]
        ln(f"{p}.mhsa.ln", m["ln"])
        for name in ("q_proj", "k_proj", "v_proj", "pos_proj", "out_proj"):
            linear(f"{p}.mhsa.{name}", m[name])
        put(f"{p}.mhsa.pos_bias_u", m["pos_bias_u"])
        put(f"{p}.mhsa.pos_bias_v", m["pos_bias_v"])
        c = b["conv"]
        ln(f"{p}.conv.ln", c["ln"])
        for pw in ("pw1", "pw2"):
            put(f"{p}.conv.{pw}.weight", np.asarray(c[pw]["kernel"]).T[:, :, None])
            put(f"{p}.conv.{pw}.bias", c[pw]["bias"])
        dw = np.asarray(c["dw_kernel"]).transpose(2, 1, 0)  # [k, 1, D] -> [D, 1, k]
        put(f"{p}.conv.dw.weight", dw)
        put(f"{p}.conv.dw.bias", rng.standard_normal(dw.shape[0]))
        put(f"{p}.conv.bn.weight", c["bn"]["scale"])
        put(f"{p}.conv.bn.bias", c["bn"]["bias"])
        put(f"{p}.conv.bn.running_mean", rng.standard_normal(dw.shape[0]))
        put(f"{p}.conv.bn.running_var", rng.uniform(0.5, 2.0, dw.shape[0]))
        sd[f"{p}.conv.bn.num_batches_tracked"] = np.array(1000, np.int64)
        ln(f"{p}.ln", b["ln_out"])
    ln("encoder.ln_out", enc["ln_out"])
    linear("ctc_head", tree["ctc_head"])
    dec = tree.get("decoder")
    if dec is not None:
        put("decoder.emb.weight", dec["embedding"])
        ln("decoder.ln", dec["ln_out"])
        linear("decoder.out", dec["out"])
        for i in range(sum(k.startswith("layer") for k in dec)):
            lay, p = dec[f"layer{i}"], f"decoder.dec.layers.{i}"
            for name, ref in (("self_attn", "self_attn"), ("cross_attn", "multihead_attn")):
                a = lay[name]
                put(f"{p}.{ref}.in_proj_weight",
                    np.concatenate([np.asarray(a[q]["kernel"]).T for q in "qkv"]))
                put(f"{p}.{ref}.in_proj_bias", np.concatenate([a[q]["bias"] for q in "qkv"]))
                linear(f"{p}.{ref}.out_proj", a["o"])
            linear(f"{p}.linear1", lay["ff1"])
            linear(f"{p}.linear2", lay["ff2"])
            for j in (1, 2, 3):
                put(f"{p}.norm{j}.weight", lay[f"ln{j}"]["scale"])
                put(f"{p}.norm{j}.bias", lay[f"ln{j}"]["bias"])
    return sd


def _layer(tree, i):
    """Layer i of a tree of [L, ...]-stacked leaves."""
    return {k: _layer(v, i) if isinstance(v, dict) else np.asarray(v)[i] for k, v in tree.items()}


EXPORT_BEAM_FRAMES = 35  # raw frames of step 19 (e)'s beam artifact: T' = 8 (its loop unrolls)


def exported_artifact(what, root, export, meta, smi):
    """Step 19: export (a call returning an ExportedProgram, or {device:
    program}), save it as an artifact directory under `root` and load its
    default member (cuda) back -> (callable, meta, path), printing the
    export, save and load seconds and each member's size (the cuda
    program's graph)."""
    from onebit_asr_tpu_torch import export as ex

    path = os.path.join(root, "".join(c for c in what.split()[0] if c.isalnum()))
    t0 = time.perf_counter()
    ep = export()
    t1 = time.perf_counter()
    ex.save_artifact(ep, path, meta)
    t2 = time.perf_counter()
    fn, meta = ex.load_artifact(path)
    t3 = time.perf_counter()
    mb = {d: round(os.path.getsize(os.path.join(path, f)) / 1e6, 2)
          for d, f in meta["members"].items()}
    ep = ep["cuda"] if isinstance(ep, dict) else ep
    ops = sum(str(n.target).startswith("onebit.") for n in ep.graph.nodes)
    log(f"export {what}: export_s={t1 - t0:.2f} save_s={t2 - t1:.2f} load_s={t3 - t2:.2f} "
        f"platforms={meta['platforms']} member_mb={mb} graph_nodes={len(ep.graph.nodes)} "
        f"custom_op_nodes={ops} signature {meta['signature']} [{smi}]")
    return fn, meta, path


def paired_ms(fa, fb, rounds: int = 6, iters: int = 3):
    """ms per call of fa and of fb, timed in alternating rounds (ab, ba,
    ab, ...; CUDA events around `iters` calls each) after one call of each:
    (median a, median b, [min, max] of the rounds' a/b ratios)."""
    fa(), fb()
    ta, tb = [], []
    for r in range(rounds):
        for fn, out in ((fa, ta), (fb, tb))[::1 if r % 2 == 0 else -1]:
            out.append(cuda_ms(fn, iters=iters, warmup=0))
    ratios = [a / b for a, b in zip(ta, tb)]
    return float(np.median(ta)), float(np.median(tb)), [min(ratios), max(ratios)]


def artifact_vs_live(what, kernels, fn, live, args, want, smi):
    """Step 19: an offline log-probs artifact against the live forward on the
    same inputs: the kernel launches of one artifact call (`want`), its
    valid frames equal, its log-probs within mean |d| <= 1e-3 and argmax
    agreement >= 0.99 (the share bit-equal printed), ms per batch of both
    (paired_ms: CUDA events, alternating rounds)."""
    _reset(kernels)
    lp_a, enc_a = fn(*args)
    torch.cuda.synchronize()
    counts = _counts(kernels)
    with torch.no_grad():
        lp_l, enc_l = live(*args)
    mask = torch.arange(lp_a.shape[1], device=lp_a.device)[None] < enc_l[:, None]
    d = (lp_a - lp_l).abs()[mask]
    agree = (lp_a.argmax(-1) == lp_l.argmax(-1))[mask].float().mean().item()
    same = (lp_a == lp_l)[mask].float().mean().item()
    finite = bool(torch.isfinite(lp_a[mask]).all())
    with torch.no_grad():
        ms_a, ms_l, ratios = paired_ms(lambda: fn(*args), lambda: live(*args))
    log(f"export {what}: B={args[0].shape[0]} T={args[0].shape[1]} T'={lp_a.shape[1]} "
        f"launches={counts} valid_frames={int(mask.sum())} logprob max|d|={d.max().item():.4g} "
        f"mean|d|={d.mean().item():.4g} argmax_agree={agree:.4f} bit_equal={same:.4f} "
        f"ms_per_batch (median of 6 alternating rounds of 3) artifact={ms_a:.2f} "
        f"live={ms_l:.2f} artifact/live per round {ratios[0]:.3f}-{ratios[1]:.3f} [{smi}]")
    if (counts != want or not torch.equal(enc_a, enc_l) or not finite
            or d.mean().item() > 1e-3 or agree < 0.99):
        raise AssertionError(f"export {what}: launches {counts} (want {want}), or the "
                             f"artifact strays from the live forward")


def export_phase(kernels, seed, smi):
    """Step 19 (a)-(d): step 3's random Conformer-M exported through
    export.py on the card, saved, loaded and run on step 3's features; see
    the module docstring. (e) runs at the end of step 13 and (f) inside
    step 17, on their runs."""
    from onebit_asr_tpu_torch import export as ex
    from onebit_asr_tpu_torch.convert import init_params
    from onebit_asr_tpu_torch.model.presets import apply_preset
    from onebit_asr_tpu_torch.ops.frontend import LogMelFrontend, apply_cmvn
    from onebit_asr_tpu_torch.utils.config import ModelConfig

    t_phase = time.perf_counter()
    cfg = apply_preset(ModelConfig(), "m")
    params = init_params(cfg, seed)
    batch, lens = pcm_batch(synthetic_waveforms(seed))
    cmvn = [torch.from_numpy(a).to(DEVICE) for a in cmvn_of(batch, lens)]
    with torch.no_grad():
        feats, feat_lens = LogMelFrontend()(torch.from_numpy(batch).to(DEVICE),
                                            torch.from_numpy(lens).to(DEVICE))
        feats = apply_cmvn(feats, *cmvn)
    frames, L = feats.shape[1], 9 * cfg.enc_layers
    build_root = os.path.join(REPO, "onebit_asr_tpu_torch", "_build")
    os.makedirs(build_root, exist_ok=True)
    fcfg = dataclasses.replace(cfg, fused_subsampler=True, fused_attention=True)
    fused = {"fused_subsample": 1, "fused_relpos_attention": cfg.enc_layers}
    with tempfile.TemporaryDirectory(dir=build_root) as root:
        # (a), (b): packed at precision 2, B=8: (a) the serving form with both
        # fused flags and bf16 activations, a cuda and a cpu member, (b)
        # without them, int8 activations, for the card alone
        for part, c, int8_act, want, platforms in (
                ("(a)", fcfg, False, {"ternary_matmul_bf16": L, **fused}, ("cuda", "cpu")),
                ("(b)", cfg, True, {"ternary_matmul_w2a8": L}, (DEVICE,))):
            kw = dict(packed=True, emit="logprobs", int8_act=int8_act)
            what = (f"{part} packed p2 B={BATCH}{' int8_act' if int8_act else ''}"
                    f"{' fused' if c.fused_attention else ''}, platforms {','.join(platforms)}")
            fn, meta, path = exported_artifact(what, root, lambda: ex.export_offline(
                c, params, 2, frames, BATCH, platforms=platforms, **kw), ex.artifact_meta(
                c, 2, "offline", "logprobs", True, {"int8_act": int8_act}), smi)
            live = ex.build_offline_forward(c, params, 2, device=DEVICE, **kw)
            artifact_vs_live(what, kernels, fn, live, (feats, feat_lens), want, smi)
            if "cpu" in platforms:
                cpu_member_check(what, kernels, path, fn, c, feats, feat_lens, smi)
            del fn, live
        # (c), (d): both fused flags, unpacked at precision 2, one symbolic-batch
        # artifact serving B=8 and B=1
        what = "(c,d) unpacked p2 fused, symbolic batch"
        fn, meta, _ = exported_artifact(what, root, lambda: ex.export_offline(
            fcfg, params, 2, frames, None, emit="logprobs", device=DEVICE),
            ex.artifact_meta(fcfg, 2, "offline", "logprobs"), smi)
        live = ex.build_offline_forward(fcfg, params, 2, emit="logprobs", device=DEVICE)
        for B in (BATCH, 1):
            artifact_vs_live(f"(c,d) unpacked p2 fused, symbolic batch at B={B}", kernels, fn,
                             live, (feats[:B], feat_lens[:B]), fused, smi)
        del fn, live
    log(f"export: step 19 (a)-(d) wall_s={time.perf_counter() - t_phase:.2f} [{smi}]")


def cpu_member_check(what, kernels, path, fn_cuda, cfg, feats, feat_lens, smi):
    """Step 19 (a)'s cpu member: loaded by device from the artifact whose
    cuda member `fn_cuda` is, run on the same features on the host, it
    launches nothing, gives the cuda member's valid frames and is held
    against its log-probs at step 3's serving tolerances (mean |d| <= 0.05,
    argmax agreement >= 0.9)."""
    from onebit_asr_tpu_torch import export as ex

    fn_cpu, meta = ex.load_artifact(path, "cpu")
    if meta["device"] != "cpu" or meta["platforms"] != ["cuda", "cpu"]:
        raise AssertionError(f"export {what}: cpu member meta {meta['platforms']}")
    lp_g, enc_g = fn_cuda(feats, feat_lens)
    _reset(kernels)
    t0 = time.perf_counter()
    lp_c, enc_c = fn_cpu(feats.cpu(), feat_lens.cpu())
    cpu_ms = (time.perf_counter() - t0) * 1e3
    if any(_counts(kernels).values()) or lp_c.device.type != "cpu":
        raise AssertionError(f"export {what}: the cpu member launched {_counts(kernels)}")
    if not torch.equal(enc_c, enc_g.cpu()):
        raise AssertionError(f"export {what}: the members' valid frames differ")
    mask, d_max, d_mean, agree = _compare(f"export {what}", lp_c, lp_g.cpu(), enc_c,
                                          cfg.vocab_size, cfg.time_pad_multiple)
    log(f"export {what}: cpu member vs cuda member on valid frames ({int(mask.sum())}): "
        f"logprob max|d|={d_max:.4g} mean|d|={d_mean:.4g} argmax_agree={agree:.4f}; cpu member "
        f"ms_per_batch={cpu_ms:.1f} (host clock, one call) [{smi}]")
    if d_mean > 0.05 or agree < 0.9:
        raise AssertionError(f"export {what}: the cpu member strays from the cuda member")


def launches_per_batch(label, fn, pad: int = 256, tries: int = 3):
    """Device kernels (and copies) one call of `fn` runs (torch.profiler),
    behind `pad` opening spins. A profile that kept none of them may have
    lost kernels too (ROADMAP C3: after a long session, as the beam + LM's
    ~174,000 kernels, the next one dropped all 256): it is taken again
    behind 4x as many, as device_ms does; raises after `tries`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for n in range(1, tries + 1):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            opening_spins(pad)
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if any(SPIN_KERNEL in e.name for e in events):
            break
        log(f"serve launches {label}: profile {n} of {tries} kept none of its {pad} opening "
            f"spins (ROADMAP C3); taking it again")
        pad *= 4
    else:
        raise AssertionError(f"serve launches {label}: no profile in {tries} kept any of its "
                             f"opening spins, so each may have lost kernels too (ROADMAP C3)")
    events = [e for e in events if SPIN_KERNEL not in e.name]
    copies = sum(1 for e in events if e.name.startswith(("Memcpy", "Memset")))
    log(f"serve launches {label}: device_kernels_per_batch={len(events) - copies} "
        f"copies_per_batch={copies}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also print where one batch's device time goes")
    ap.add_argument("--no_real_data", action="store_true",
                    help="skip step 14 (to tell its effect on the later device steps)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()

    from onebit_asr_tpu_torch.convert import init_params
    from onebit_asr_tpu_torch.model.conformer import subsampled_frames
    from onebit_asr_tpu_torch.model.presets import apply_preset
    from onebit_asr_tpu_torch.ops import _build
    from onebit_asr_tpu_torch.utils.config import ModelConfig

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as ptxas:
        so = _build.build(verbose=True)  # silent when already built
    _build.library()
    log(f"build: {so.name} in {time.perf_counter() - t0:.2f} s")
    for line in ptxas.getvalue().splitlines():
        if "Compiling entry" in line or "registers" in line:
            log(f"build: {line.strip()}")

    cfg = apply_preset(ModelConfig(), "m")
    frames = 1 + (16 * SAMPLE_RATE - 400) // 160
    t_sub = subsampled_frames(frames)
    t_pad = -(-t_sub // cfg.time_pad_multiple) * cfg.time_pad_multiple
    rows = kernel_phase(cfg, t_pad, args.seed)
    subsample_kernel_phase(cfg, frames, args.seed, rows)
    attention_kernel_phase(cfg, t_pad, t_sub, args.seed, rows)
    attention_bwd_kernel_phase(cfg, args.seed, rows)
    subsample_bwd_kernel_phase(cfg, args.seed, rows)

    ctc_kernel_phase(args.seed, rows)
    log("kernels: every kernel agrees with its plain version at the path's shapes")

    params = init_params(cfg, args.seed)
    profiles = path_phase(cfg, params, synthetic_waveforms(args.seed), rows)
    log("path: transcribe ran on the kernels and agrees with the plain path")
    del params

    kernels = smoke_kernels()
    profiles += train_step_phase(cfg, args.seed, rows, kernels)
    for flag in ("fused_attention", "fused_subsampler"):
        profiles += train_step_phase(dataclasses.replace(cfg, **{flag: True}), args.seed,
                                     rows, kernels)
    build_root = os.path.join(REPO, "onebit_asr_tpu_torch", "_build")
    os.makedirs(build_root, exist_ok=True)
    one_process = data_parallel_phase(kernels, args.seed, smi)  # times steps: before any
    log("data parallel: the data-parallel and ZeRO-2 steps over nccl ran rows 3-8 as the "
        "one-process step does and matched it; torchrun --fsdp trained and resumed")
    tensor_parallel_phase(kernels, args.seed, smi, one_process)  # profiler run too
    del one_process
    log("tensor parallel: two ranks on the card over gloo ran rows 3-4 on half the heads and "
        "rows 5-8 whole, as often as the one-process step, and matched it at dropout 0 and "
        "0.1; rows 3-4 at the local shape agree with their plain versions")
    pipeline_parallel_phase(kernels, args.seed, smi)  # times steps: before any profiler run
    log("pipeline parallel: two stages on the card over gloo ran rows 3-4 on their blocks' "
        "microbatches, rows 5-6 on stage 0 alone and rows 7-8 on both, and matched the "
        "one-process step at dropout 0 and 0.1; rows 3-4 at a microbatch's shape agree with "
        "their plain versions")
    with tempfile.TemporaryDirectory(dir=build_root) as runs:
        train_cli_phase(kernels, runs)
        log("train: the QAT step and the train CLI ran on the CTC kernels, under "
            "fused_attention on the attention kernels and under fused_subsampler on the "
            "subsampler kernels too")
        # step 13 times host-bound loops: before any profiler run
        served = serve_phase(runs, kernels, args.seed)
    log("serve: the runs the train CLI wrote were served packed and unpacked, greedy, "
        "with the beam and the LM and long-form, and evaluated, on the kernels")
    if not args.no_real_data:  # times steps: before any profiler run too
        real_data_phase(kernels, args.seed, smi)
        log("real data: trained over three bucket lengths on the wav and the feature-cache "
            "paths, held rows 3-8 against their plain versions at each bucket's shapes, "
            "evaluated and transcribed through the CLIs, on the kernels")
    # times steps: before any profiler run too (a finished profiler session
    # slows host code)
    chunk_steps = model_options_phase(kernels, args.seed, smi)
    served += chunk_steps
    profiles += [(label, fn, 15) for label, fn in chunk_steps]
    log("model options: trained, evaluated and served the streaming encoder (rows 3-4 off under "
        "the chunk mask), the quantized reference decoder (128 packed launches per eval "
        "forward) and per-channel alpha (the packed export refused), on the kernels")
    log("streaming: sessions, an 8-slot server and the serve daemon decoded the streaming run "
        "as its offline chunked encoder does, and evaluate --streaming ran")
    reference_checkpoint_phase(kernels, args.seed, smi)  # times batches: before any profiler
    log("reference: a reference-layout Conformer-M checkpoint evaluated unpacked and packed "
        "(108 launches of row 1, or row 2 with --int8_act, a forward) through "
        "evaluate --torch_checkpoint")
    export_phase(kernels, args.seed, smi)  # times batches: before any profiler run too
    log("export: packed (108 launches of row 1, or of row 2 with --int8_act, a forward; row 5 "
        "once and row 3 12 times with the fused flags), fused unpacked (row 5 once, row 3 12 "
        "times) and symbolic-batch artifacts ran from their programs alone and "
        "agree with the live forward, and a cuda,cpu artifact's cpu member with its cuda "
        "member; the beam artifact (step 13) and serve --artifact (step 17) too")
    prepare_options_phase(kernels, args.seed, smi)  # times steps: before any profiler run too
    log("prepare and options: prepared a corpus on the card (CMVN and features equal to the "
        "CPU's), trained it with --grad_accum 2 --multistep 2 and --fp32_control, held rows 3-8 "
        "of both steps against their plain versions, and profiled an epoch")
    kernel_device_phase(cfg, t_pad, args.seed, rows)
    subsample_device_phase(cfg, frames, args.seed, rows)
    attention_device_phase(cfg, t_pad, t_sub, args.seed, rows)
    ctc_device_phase(args.seed, rows)
    for label, fn in served:
        launches_per_batch(label, fn)
    for what, fn, top in profiles if args.profile else ():
        log(f"profile of {what}:")
        profile_breakdown(fn, top)
    del profiles, served

    log(f"device_ms: {len(PROFILES)} calls, profiles taken per call "
        f"{ {n: PROFILES.count(n) for n in sorted(set(PROFILES))} } (step 14 "
        f"{'skipped' if args.no_real_data else 'run'} before them); opening spins lost by "
        f"a profile: max {max(PAD_LOST, default=0)}, mean "
        f"{float(np.mean(PAD_LOST)) if PAD_LOST else 0.0:.2f} over {len(PAD_LOST)} profiles "
        f"(ROADMAP C3)")
    log(f"chip_smoke: wall_s={time.perf_counter() - t_start:.2f} (the build included) "
        f"[{smi}]")
    print(json.dumps({"kernels": list(rows.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
