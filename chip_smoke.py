#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (multimodalsignal_tpu_torch) on one GPU.

    python chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. The card: name and power limit from nvidia-smi, torch's device name.
2. Build every CUDA source of the port with nvcc (one process each, all at
   once) into multimodalsignal_tpu_torch/ops/build/; print ptxas's
   registers and spills per kernel instantiation and fail on any spill;
   check each kernel's shared-memory size in C against its wrapper's
   formula, the walk kernel's row tile (gru_fwd, gru_fwd_fb, gru_bifwd), and
   the adjoint walk's (gru_bwd, gru_bwd_fb, gru_bibwd) row tile, chunks of
   rows, the two passes' grids (gru_adj_pass_plan) and workspace at 1, 2,
   15 and 60 lanes, and at M2's H=32.
3. One phase per kernel: the wrapper on CUDA tensors against its plain
   PyTorch version on the same inputs, float32 and bfloat16, both walk
   directions, at the serving/training shape (T=480, B=64, H=64; F=2 lanes
   for the _fb kernels) and a ragged one; the walk kernel also at
   WALK_CASES (gru_fwd, and gru_bifwd in float32: M2's H=32, H=128, the
   largest H each dtype admits, B=1, B=256 and T=1) and FB_CASES
   (gru_fwd_fb: the same at two lanes, and F=4 at B=128, F=15 at B=64 for
   row tiles 4 and 8, F=15 at H=32, and F=60 at B=64, a 4-seed replicated
   sweep's lanes), each line with its row tile and instantiation (W^T in
   registers or in shared memory); the adjoint walk (gru_bwd) also at
   ADJ_CASES (H=32 with a full dy and with a dy that is zero but at the
   forward's last step, H=95 f32, 109 bf16, 128, B=1, B=256, T=1, and the
   last-step dy at H=64), gru_bwd_fb at FB_ADJ_CASES (ADJ_CASES at two
   lanes, F=4 at B=128 and F=15 at B=64, F=15 at H=32 with either dy, F=60
   at B=64), gru_bibwd at BI_ADJ_CASES (H=95, 128, 130, B=1, B=256, T=1,
   each direction's outputs held on their own), each line with its row
   tile, walk blocks, instantiation and chunks; each of the three twice on
   the same inputs with dW and db bitwise equal; then the walks' float32
   time as B grows, and gru_bwd_fb at 2, 15 and 60 lanes and gru_fwd_fb at
   15 and 60 lanes, each line with the walk blocks an SM holds at once and
   the waves (walk_sweep); then M2's shape (H=32; 1 lane and 15 lanes of
   gru_fwd, gru_fwd_fb, gru_bwd, gru_bwd_fb): kernel, bound and cuDNN
   (m2_shape_timings). Kernel inputs are drawn on the card from a seeded
   torch generator. TF32 is off for matmul and cuDNN.
   Forward kernels (gru_fwd, gru_fwd_fb): ys, float32 rtol = atol = 1e-5,
   bfloat16 atol 0.05. Adjoint kernels (gru_bwd, gru_bwd_fb): all four
   outputs, tolerances in BWD_TOL. Then the times at the main shape: the
   kernel, the plain version (one call), the least time the card could
   take, and cuDNN's GRU (nn.GRU: the forward, or for an adjoint kernel the backward
   as forward+backward minus forward; it also does the input projection),
   and us per dependent step (ms / T); for each adjoint kernel also a
   profiler trace of its four kernels (gate pre-pass, walk, weight-gradient
   pass, reduction) and its split by kernel (adjoint_split: each of the two
   passes over all T beside its bound and torch.mm's time for its product).
   Then the passes' sub-phase (passes_phase): one call of gru_bwd_fb at 15
   and 60 lanes (H=64) and 15 lanes at H=256, and of gru_bwd at H=1024,
   f32 and bf16, split by kernel; the pre-pass's six factors read back from
   the workspace against their plain version (gru_cuda.adj_factors_plain).
4. The serving path: the default-config CnnGruAttention model (C=3,
   T=7680, H=64, 2 layers) with weights from a numpy seed, in float32 and
   bfloat16, behind the port's HTTP server: GET /healthz, POST /v1/predict
   with 1, 7, 64 and 100 windows, POST /v1/predict_recording on a
   WESAD-format pickle written here. Probabilities must be finite rows
   summing to 1 and equal to the same model's on the CPU (float32 atol
   1e-4, bfloat16 atol 3e-2); each forward kernel must have been launched
   once per padded batch and each adjoint kernel never. In float32 the
   same probabilities once more with TF32 as torch's defaults set it and
   the port's CLIs leave it (cuDNN's on), their distance from the CPU
   printed beside the TF32-off one. Then the padded-64 forward's time, and
   a profiler trace of it: device time by kernel and the device's idle
   share.
5. The training path, float32 and bfloat16, same model and seed weights,
   on synthetic windows [3, 7680] made with numpy (200 train, 64 val):
   a. with dropout 0, the first steps on the card (two full batches and the
      padded last one) against the same steps of the port on the CPU (impl
      "cuda" on CPU tensors: the kernels' plain versions): per-step losses
      and the parameters afterwards, tolerances in TRAIN_TOL; after the
      first step every parameter has a finite, nonzero gradient (but
      gru.l1_bwd_w_hh, zero by construction, see check_gradients); in
      float32 the card's steps once more with TF32 as the CLIs leave it,
      printed beside the TF32-off distance;
   b. Trainer.train for 2 epochs at the config's dropout 0.5: finite
      losses, a best_model.msgpack the port reads back, and each kernel
      launched once per real train step (the forward kernels also once per
      eval batch);
   c. the ms per train step and windows/s at B=64, the peak device memory
      of one step, and a profiler trace of back-to-back train steps: device
      time by kernel and the idle share (step_profile).
6. The serial LOSO experiment CLI with gru_impl="pallas_fused", float32 and
   bfloat16, on a synthetic preprocessed data directory written here with
   numpy (4 subjects x 48 windows [7680, 8], raw labels 1-4, the chest
   channel names):
   a. the first 3 train steps of the first fold, dropout 0, on the card
      against the port on the CPU (the plain versions), as in 5a;
   b. `python -m multimodalsignal_tpu_torch.main --execution serial --set
      model.gru_impl=pallas_fused --set trainer.epochs=2` (in process): a
      run directory with config.json, cv_summary.txt of 4 folds with finite
      numbers and a best_model.msgpack per fold that the port reads back;
      gru_bifwd and gru_fwd launched once per train step and eval batch,
      gru_bibwd and gru_bwd once per train step, the fb kernels never;
   c. each fold's wall time, and step_profile of pallas_fused train steps
      at B=64.
7. The sharded LOSO sweep, the CLI's default execution, float32 and
   bfloat16 at the default gru_impl (auto), on a synthetic preprocessed
   data directory of the config's 15 subjects x 48 windows (as in 6), so
   every fold is one of F=15 lanes at full model width:
   a. with dropout 0, the first 3 sweep train steps of all 15 folds on the
      card, lane 0 against the port on the CPU (gru_impl "pallas": the
      F-lane kernels' plain versions; 1 lane there, CPU_FOLDS, as 15 took
      over 60 s), under TRAIN_TOL; then lanes 0 and 14 of the
      card's first step against the single-fold Trainer.train_step on the
      card with that fold's weights and batch (sweep_parity);
   b. `python -m multimodalsignal_tpu_torch.main --set trainer.epochs=2`
      with no --execution (in process): a run directory with config.json,
      cv_summary.txt of 15 finite folds and each fold's best_model.msgpack
      read back by the port's Predictor; gru_fwd_fb launched 3 times per
      train step and eval batch, gru_bwd_fb 3 times per train step, every
      other kernel never (sweep_expected_launches, from the FoldBatch);
   c. step_profile of sweep train steps of all 15 folds at B=64 (960
      windows a step) at the config's dropout; then one pallas_db step,
      which under the fold axis takes the same per-direction F-lane walks
      (3 launches of each fb kernel a step).
8. The fold ensemble of phase 7's float32 run directory (EnsemblePredictor,
   15 lanes): 100 windows in 2 padded batches (3 gru_fwd_fb launches a
   batch, no adjoint) against the mean of the 15 per-fold Predictors (atol
   1e-5) and the ensemble on the CPU (PROB_ATOL); the padded-64 forward's
   time and trace; `python -m multimodalsignal_tpu_torch.serving --run-dir`
   answering one /v1/predict.
9. WESAD pickles to a trained and served hybrid model:
   a. synthetic WESAD pickles of the config's 15 subjects (DEFAULT_TASKS,
      8.5 minutes each at 700 Hz, from PICKLE_SEED) written by the port's
      write_synthetic_wesad, then `python -m
      multimodalsignal_tpu_torch.data.preprocess` (in process; targets raw,
      raw-align and feature): channel and feature names, meta files, shapes,
      finite features, equal raw-align and feature window counts per
      subject, and pack_corpus_from_pickles bitwise equal to pack_corpus of
      the written chest_raw; the preprocess host seconds;
   b. `main --from-pickles <WESAD> --set trainer.epochs=2` (float32): the
      sweep's launch counts as in 7b, 15 finite folds, config.json carrying
      the pickles' preprocess_meta, the mean test accuracy (not a gate);
   c. the sweep of model.name=hybrid_cnn_gru on the raw-align and feature
      targets, float32 and bfloat16, 15 folds as lanes at full width: 7a's
      first-steps parity and lanes vs Trainer.train_step, 7b's CLI checks
      and launch counts (the feature branch launches no GRU kernel), and
      step_profile at B=64;
   d. the hybrid serial LOSO (`--execution serial`, 4 subjects, float32,
      auto, 2 epochs): one launch of gru_fwd_fb, gru_fwd and each adjoint a
      train step, of each forward an eval batch;
   e. the hybrid fold ensemble of c's float32 run: predict_recording on a
      pickle of a (3 gru_fwd_fb a padded batch) against the mean of the 15
      fold Predictors (atol 1e-5) and the CPU (PROB_ATOL); `serving
      --run-dir` answering /v1/predict with features, and 400 without.
   Then the phase's seconds.
10. The experiments beyond plain LOSO, on the data of phases 6, 7
    and 9:
    a. `main --hierarchical --from-pickles <WESAD> --set
       base.trainer.epochs=2` (f32, the default HierarchicalConfig: M1 H=64
       x 2 layers, M2 H=32 x 1 layer, 15 folds as lanes): first the first 3
       M2 sweep steps card vs CPU under TRAIN_TOL (sweep_parity, dropout 0);
       then the CLI, counted (M1's sweep 3 gru_fwd_fb + 3 gru_bwd_fb a
       train step and 3 gru_fwd_fb an eval batch, M2's 1 + 1 and 1, the
       composed evaluation 3 + 1 gru_fwd_fb a test batch), a
       hierarchical_summary.txt of 15 finite folds, every
       model_m{1,2}/best_model.msgpack read back (M2's with one GRU layer),
       the mean composed accuracy (not a gate), step_profile of an M1 and
       an M2 sweep step;
    b. `main --hierarchical --execution serial` on phase 6's 4 subjects
       (f32, auto): each stage's single-fold kernels once a train step and
       eval batch, 4 finite folds, both stages' checkpoints;
    c. HierarchicalPredictor.from_run on a's run, fold S2: predict_recording
       of a phase 9 pickle (counted), its labels the hard gate of the two
       stage Predictors run by hand, its probabilities their product (atol
       1e-6) and the CPU's (PROB_ATOL); `experiments.predict --run-dir
       --fold S2` in a subprocess;
    d. `main --seeds 42 43 44 45 --set trainer.epochs=2` on phase 7's data
       (f32, 60 lanes): seed_summary.{txt,json} and seed_fold_matrix.npz;
       3 + 3 launches a train step; seed group 0 against phase 7's f32
       single-seed sweep under SEED_GROUP_TOL (printed whether bitwise);
       step_profile at 60 lanes, f32 and bf16, with the peak memory;
    e. the ablation CLI on phase 7's data (subsets ecg and fusion4 by
       models cnn_gru_attention and cnn_gru, sharded, 2 epochs): four
       sweeps' launches, ablation_summary.txt and four finite points.
    Then the phase's seconds.
11. The deployment tier, on the runs of phases 7, 9 and 10:
    a. `experiments.export` (in process) of phase 7's f32 run (--fold all:
       the 15-fold ensemble, and --fold S2), its bf16 run (--fold S2) and
       phase 9's f32 hybrid run (--fold S2, artifact version 2); each
       artifact loaded on the card against its EnsemblePredictor or
       Predictor on the card (PROB_ATOL) and against itself on the CPU, for
       1, 7, 64 and 100 windows, with TF32 off and again as the CLIs leave
       it (both within PROB_ATOL of the TF32-off Predictor); the padded-64
       forward of the artifact (cuDNN's GRU) against the Predictor's (the
       hand-written kernels), with a trace of the f32 artifacts'; the
       ensemble artifact run in a subprocess by torch alone, without the
       package in sys.modules, then there through ExportedPredictor, whose
       load packs each GRU's weights into cuDNN's layout (cuDNN's
       weight-copy warning must not appear); `serving --artifact`
       answering /v1/predict with backend artifact-ensemble[15];
    b. the `experiments.streaming` CLI (in process, counted) on the phase 9
       pickle S2 (8.5 minutes at 700 Hz): the ensemble on the native feed
       (3 gru_fwd_fb a padded batch, no adjoint; an event a window of the
       recording; the events the ensemble's on the stream's frozen-stats
       windows, PROB_ATOL), one fold by --checkpoint --config --feed
       resampled (1 gru_fwd_fb + 1 gru_fwd a batch; against the Predictor),
       the hybrid fold S2, phase 10a's hierarchical fold S2 (1 gru_fwd_fb +
       2 gru_fwd a batch; its labels the hard gate of its stages), the
       ensemble artifact (no hand-written kernel; its events the checkpoint
       stream's), and a stdin feed of 300 s at 700 Hz; events/s and the
       real-time factor of each;
    c. a reference-topology best_model.pt (default widths, numpy-seeded
       weights) through the import CLI: Predictor.from_files on the card
       against the reference model's softmax on the CPU (PROB_ATOL);
    d. a random-weight checkpoint on chest_ECG, wrist_BVP, wrist_EDA:
       predict_recording of the pickle on the card against the CPU.
    Then the phase's seconds, and each part's.
12. Mid-run resume, the sweep's profiler trace and the attention probe, on
    the data and runs of phases 6, 7 and 10:
    a. the 15-lane float32 sweep of phase 7's data at full width for 4
       epochs, uncut; then with trainer.checkpoint_every=1 and
       abort_after_epoch=2 (SweepAborted); then resumed from its bundle
       (counted: exactly 2 epochs' gru_fwd_fb and gru_bwd_fb, and the test
       batches); resumed against uncut under TRAIN_TOL, printed whether
       bitwise; the bundle's size, write and read times; the uncut sweep
       run again, bitwise equal (train steps hold cuDNN to its
       deterministic algorithms), and once with cuDNN's default algorithms
       (their drift from it and the seconds of each, printed);
    b. the serial Trainer on fold 0 of phase 6's 4 subjects (auto, float32,
       dropout 0.5), cut after epoch 2 and resumed the same way (counted:
       gru_fwd_fb, gru_fwd, gru_bwd_fb and gru_bwd once a train step of the
       remaining epochs, the forwards once an eval batch), against uncut
       under TRAIN_TOL;
    c. `main --profile-dir D --set trainer.epochs=1` (counted as one sweep
       epoch): D's Chrome trace names gru_fwd_fb and gru_bwd_fb (each
       launch's range) beside the walk kernels;
    d. the attention probe CLI (`analysis.attention_probe`, counted: one
       gru_fwd_fb and one gru_fwd a padded chunk of 256 windows) on phase
       7's float32 run (C=3, the constant gate) and phase 10e's fusion4 run
       (C=4, a rank-1 gate), rail and flatline at rates 0, 0.5 and 1; fold
       S2 of the fusion4 run against the probe on the CPU (probabilities
       within PROB_ATOL, gate statistics equal, accuracies within a
       window).
    Then the phase's seconds, and each part's.
13. gru_impl="pallas_fused" under the fold axis (every fold's two
    directions as 2F lanes of the fused pair) and the pack cache, on the
    data and runs of phases 6, 7 and 10:
    a. gru_bifwd and gru_bibwd at L = 30 and 120 lanes (15 folds, and 4
       seed groups of them; T=480, B=64, H=64) and a ragged L=6 against
       their plain versions (ys at TOL, the adjoint at BWD_TOL, dW and db
       bitwise over two runs); at the full shapes the time, the bound at L
       lanes, row tile, blocks and waves, beside auto's two F-lane walks
       (gru_fwd_fb / gru_bwd_fb) and cuDNN's bidirectional nn.GRU called F
       times (fused_lanes_phase);
    b. `main --set model.gru_impl=pallas_fused --set trainer.epochs=2` with
       no --execution, float32 and bfloat16, 15 lanes at full width, as in
       7: sweep_parity (the CPU side runs pallas_fused's plain versions;
       lanes 0 and 14 against Trainer.train_step, whose single-fold model
       walks the pair's 2 lanes), the CLI counted exactly (1 gru_bifwd, 1
       gru_bibwd, 1 gru_fwd_fb and 1 gru_bwd_fb a train step, 1 gru_bifwd
       and 1 gru_fwd_fb an eval batch: fold_walks), step_profile of a fused
       step beside an auto step;
    c. EnsemblePredictor (counted: 1 gru_bifwd + 1 gru_fwd_fb a padded
       batch) on phase 6's serial pallas_fused run directory and on b's
       float32 run, each against its fold Predictors and the CPU, and
       `serving --run-dir` on phase 6's run answering /v1/predict;
    d. `main --hierarchical --from-pickles` with m1_model.gru_impl=
       pallas_fused and `main --seeds 42 43` fused (30 folds: 60 fused
       lanes), both counted exactly; seed group 0 against b's float32 sweep
       under SEED_GROUP_TOL;
    e. the sweep CLI (1 epoch) twice on a fresh copy of phase 7's data: the
       first stages with a miss and writes one .pack_cache entry, the
       second reads it back, bitwise equal; both staging times; a
       MMS_PACK_CACHE=0 run writes nothing.
    Then the phase's seconds, and each part's.
14. The sweep split over two processes (parallel/multihost.py: a gloo
    process group, each rank a contiguous block of the lanes, 15 folds
    over 2: 8 + 7) with both ranks on the one card, on phase 7's data.
    Each rank is `python chip_smoke.py jobs JOBS.json` with
    MMS_NUM_PROCESSES / MMS_PROCESS_ID (rank_worker: each job's main
    counted under its own MMS_COORDINATOR and MMS_RUN_ID, one after
    another, reported on a "phase14 rank" line); both are killed if either
    outlives RANK_DEADLINE_S a job, and a rank that fails fails the phase.
    Every run once in this process, then the runs of a-c and d's cut as the
    jobs of one pair of rank processes (split_runs; a process's start and
    its first sweep's set-up, ~15 s a rank, are paid once, not once a run):
    the one process's launches and each rank's exactly those
    the whole sweep's steps imply (a rank runs every step over its own
    lanes), the same run-directory file list, every sweep's losses and
    parameters under TRAIN_TOL of the one process's, each rank's wall,
    sweep and epoch seconds and peak memory beside the one process's:
    a. auto f32, 2 epochs; the two-rank run directory served by
       EnsemblePredictor (one padded-64 forward, counted) against the
       one-process run's (PROB_ATOL); the train step of all 15 lanes, of
       rank 0's 8 lanes drawing the whole sweep's dropout masks, and of
       those 8 at dropout 0 (dropout_rng_cost);
    b. pallas_fused f32, 1 epoch (1 each of gru_bifwd, gru_bibwd,
       gru_fwd_fb, gru_bwd_fb a train step at 2F_r lanes);
    c. `--seeds 42 43` (30 lanes: 15 + 15) and `--hierarchical` (M1, M2 and
       the composed evaluation), 1 epoch; the seeds' confusion matrices
       within SEED_GROUP_TOL;
    d. two ranks cut after epoch 1 of 2 (the drill; a bundle with
       next_epoch 1 and no fold directory yet), then resumed by two new
       rank processes:
       each launches exactly the remaining epoch's walks; against 14a's
       uncut two-rank run under TRAIN_TOL.
    Then the phase's seconds, and each part's.
15. Hidden sizes past one block's shared memory (the cluster walk) and
    fold grouping, on phase 7's data:
    a. the C formulas of the cluster walk (cluster size, per-CTA shared
       bytes, row tile) against gru_cuda's twins for H = 1-559 in both
       dtypes, the adjoint's C plan (gru_adj_plan: the instantiation and
       tile adj_choose weighs by its model of a step) against the twin at
       every H of 1-1100, B = 1, 37, 64, 256 and 1, 2, 15 lanes, and its
       candidates' modelled costs, and ptxas's registers and spills of its
       instantiations; all six entries at H = 137, 180, 192, 256 and the
       cluster design's limit (380 / 376 f32, 532 / 522 bf16; past it the
       grid and streamed walks, phase 16), f32 and bf16 where taken, T=480
       B=64 both directions, and at H=256 also B=1, B=256 and T=1, against
       their plain versions (TOL / BWD_TOL, the fused pair per direction);
       the three adjoints also at H=256 and B=37 (a batch no row tile of 2
       or 4 divides), gru_bwd_fb also at F=15 for H=100 and H=256,
       reverse=False; dW and db bitwise over two runs at H=256 (gru_bwd_fb
       also at F=15); each adjoint at every shape of CANDIDATE_HS and AB_HS
       whose choice is not the parent commit's (moved_shapes), at T=96,
       against its plain version and bitwise over two runs;
    b. every candidate of the adjoint's plan (each tile of the one-block
       and cluster walks, the grid walk) at f32 H = 256, 300, 340, 376 and
       bf16 256, 340, 400, 450, 512, B=64 at 1, 2, 15 lanes and B=37 at 2:
       forced, against the plain version at T=16, then the walk alone at
       T=480 by CUDA events beside its waves by the plan, the model and the
       card, and the model's step; whether the plan's choice is the fastest
       or within 5 % of it; one cluster-walk step split by clock64() stamps
       (f32 H=256 F=15 5x4, bf16 H=450 F=2 7x2) into the dg_lo exchange,
       the cluster barrier, the dot and the butterfly; each adjoint at
       T=480 B=64 and H = 376 / 450 and 512: kernel ms, us per dependent
       step, the bound, the plain version, cuDNN's nn.GRU backward, the plan
       and its waves;
    c. the sweep CLI with model.gru_hidden_size=256 (f32 auto, 1 epoch) as
       in 7 (first 3 steps card vs CPU on lane 0 at B=8, exact launches, 15
       finite folds, a step profile); fold S2's Predictor at H=256 (counted: 2 gru_fwd_fb
       and 2 gru_fwd for 70 windows) against the CPU (PROB_ATOL);
    d. MMS_GRU_FOLD_GROUP=3 at F=15 (5 lanes of G*H = 192, float32 walks),
       f32 and bf16: the first 3 sweep steps grouped against ungrouped on
       the card under TRAIN_TOL with every walk's lanes and H recorded; the
       CLI grouped for 1 epoch (launches exactly the ungrouped run's);
       step ms (the median of 3 blocks of 5 steps) ungrouped, grouped,
       grouped, ungrouped, and a trace of a grouped step.
    Then the phase's seconds, and each part's.
16. The walks past the cluster walk's limit (the grid walk: W held across
    a group of CTAs spanning the card, the state exchanged through L2 with
    a group barrier a step, launched cooperatively; past its limit the
    streamed walk), the host window engine and trainer.remat, on phase 7's
    data:
    a. the C plans (gru_walk_plan, gru_adj_plan: instantiation, cluster or
       group, row tile or work item rows, resident and streamed units a
       CTA, shared bytes, workspace, groups at once and threads) against
       gru_cuda's twins for H = 1-2200 in both dtypes, ptxas's registers of
       the grid and streamed instantiations; all six entries at H = 381 /
       377 (forward / adjoint), 451 (the adjoint), 512, 768 and 1024 (the
       grid walk where it takes them), f32 and bf16 where taken, T=480 B=64
       (both directions at H=512), at H=512 also B=1, B=256 and T=1 both
       directions, the _fb entries
       also at 15 lanes, and at the first H past the grid walk's limit
       (the streamed walk) at T=16, against their plain versions; dW and db
       bitwise over two runs at H=512 and past the grid walk's limit; past
       the streamed walk's limit a ValueError naming it, before any launch;
    b. each entry at H = 1024, T=480 B=64: kernel ms, us a step,
       the bound, the plain version, cuDNN's nn.GRU, the plan, its groups
       and rounds (or clusters and waves), the bytes read from L2 a step
       (W streamed, or the state exchanged) beside the streamed walk's
       time before the grid walk took the shape;
       a step of both grid walks split by clock64() stamps (grid_step_split:
       at H=381 f32, the walk's fixed cost, and at bf16 H=1024 and F=15 H=256),
       beside the walk's us a step and the bound;
       a profile of one gru_bwd call at 1024, f32 and bf16, split by
       kernel (the times at H = 512 are kept in PERF.md);
    c. a Predictor at H=512 against the CPU (counted), the sweep at H=512
       (first 3 steps card vs CPU on lane 0 at B=8 under TRAIN_TOL; 3
       counted steps at B=64, their ms a step), MMS_GRU_FOLD_GROUP=3 at
       H=256 (G*H = 768, past the cluster walk) against ungrouped under
       TRAIN_TOL;
    d. the host window engine built and used: pack_corpus of phase 7's
       data through it once a subject (cache off), against the NumPy path,
       and both packs' seconds;
    e. trainer.remat: the f32 and bf16 sweep, 3 steps on against off under
       TRAIN_TOL (bitwise or not), exact launches in both modes; step ms and
       peak MiB off, on, on, off at 15 lanes (H = 64 and 256) and 60 lanes.
    Then the phase's seconds, and each part's.
17. The card's CI and the bench's captured train step (bench.py's step on
    the port: B=64, C=3, T=7680, pallas_db, one fixed batch; a CUDA graph
    of forward, backward, capturable Adam and the batch-norm update, the
    dropout generator registered with it):
    a. `python -m multimodalsignal_tpu_torch.gpu_ci --baseline <new file>
       -- --steps 100` in a subprocess: exit 0, the CUDA kernel tier
       (tests/test_torch_cuda_kernels.py under pytest -m cuda) all passed,
       the bench's last line with bench.py's four keys, its launches per
       captured step one eager step's, the pin created from it;
    b. float32 and bfloat16 at dropout 0: 3 replays of the captured step
       from the same weights (the weights and Adam's state restored in
       place after the warm-up) against 3 eager steps under TRAIN_TOL; the
       launches the graph holds equal one eager step's (1 each of gru_fwd,
       gru_fwd_fb, gru_bwd, gru_bwd_fb); a replay from the restored state
       repeats the first loss bitwise;
    c. at dropout 0.5 two replays from one state give different losses
       (new masks each replay);
    d. the bench's captured step and, from the same make_train_step, the
       eager step, float32 and bfloat16 at dropout 0.5: ms and steps/s of
       each, and traces of both. The float32 captured step is bench_torch
       here (10 eager warm-up steps, the capture, 3 reps of 100 replays;
       counted: 11 launches of each of the four kernels, the replays
       unseen by the counters), its graph traced; the bfloat16 one is a's
       bench, the trace c's graph of the same step;
    e. the gate (gpu_ci.check_baseline) against pins of 10x and 0.5x a's
       value: exit 2, then 0; against a pin of another metric: 1.
    Then the phase's seconds, and each part's.
Every sweep's expected launches follow trainer.remat (default true): a
train step runs each forward walk twice, the forward and its recompute in
the backward, and each adjoint once.
The fused pair (gru_bifwd, gru_bibwd) has kernel phases as in 3, float32
only: ys at TOL, the adjoint's outputs at BWD_TOL; its library time is
cuDNN's bidirectional nn.GRU. walk_sweep also times gru_fwd_fb at F=15,
B=64 (row tile 8), float32 and bfloat16.

tree_ab(parent, out, jobs, tag), not run by main(), runs jobs in the
parent commit's tree and this one in turns: adjoint_ab and grid_ab time
the adjoints and the grid walks so, train_step_ab one train step (their
docstrings say how to run them). split_scaling
(world), not run by main() either, runs phase 14's split over `world`
cards, one rank each (its docstring says how to run it).

Prints a JSON line of the kernels (launches: gru_fwd's from the float32
serving run, gru_bwd's from the float32 training run, the fb pair's from
the float32 sweep, 13b's float32 fused sweep, both ranks of 14a and 14b,
15c's and 15d's float32 CLI runs and 16c's counted runs, the fused pair's
from the float32 serial LOSO run, 13b's float32 fused sweep and both ranks
of 14b; the four single-fold kernels also 17d's float32 bench run, its
warm-up steps and its capture),
then, as the last line, {"ok": true, "device": {...}}. Needs one CUDA
device and the repository; with no arguments it runs every phase (the
argument `jobs` makes it one of phase 14's rank processes).
"""

from __future__ import annotations

import ast
import base64
import collections
import contextlib
import ctypes
import dataclasses
import functools
import io
import json
import math
import os
import pickle
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch

from multimodalsignal_tpu_torch import bench, gpu_ci
from multimodalsignal_tpu_torch import main as cli
from multimodalsignal_tpu_torch.analysis import attention_probe
from multimodalsignal_tpu_torch.config import (
    ALL_CHANNEL_NAMES,
    ALL_SUBJECTS,
    ExperimentConfig,
    HierarchicalConfig,
    ModelConfig,
    TrainerConfig,
    config_from_dict,
    save_config,
    union_channel_indices,
)
from multimodalsignal_tpu_torch.data import preprocess
from multimodalsignal_tpu_torch.data.dataset import (
    apply_channel_norm,
    build_dataset,
    channel_norm_stats,
    from_pickles_meta,
    pack_corpus,
    pack_corpus_from_pickles,
    read_channel_names,
    read_feature_names,
    read_preprocess_meta,
)
from multimodalsignal_tpu_torch.data.features import FEATURE_EXTRACTOR_VERSION, FEATURE_NAMES
from multimodalsignal_tpu_torch.data.resample import StreamingPolyResampler
from multimodalsignal_tpu_torch.data.synthetic import DEFAULT_TASKS, write_synthetic_wesad
from multimodalsignal_tpu_torch.data.windowing import sliding_windows, window_starts
from multimodalsignal_tpu_torch.experiments import ablation, export, import_torch, streaming
from multimodalsignal_tpu_torch.experiments.export import ExportedPredictor
from multimodalsignal_tpu_torch.experiments.predict import (
    EnsemblePredictor,
    HierarchicalPredictor,
    Predictor,
    _recording_grid,
    num_windows,
)
from multimodalsignal_tpu_torch.experiments.splits import loso_folds
from multimodalsignal_tpu_torch.models.cnn_gru import build_model
from multimodalsignal_tpu_torch.models.convert import (
    export_jax_variables,
    lane_variables,
    load_jax_variables,
    stack_variables,
)
from multimodalsignal_tpu_torch.models.fold_stack import FOLD_IMPLS, FoldStackedModel
from multimodalsignal_tpu_torch.ops import _build, gru_cuda
from multimodalsignal_tpu_torch.parallel import fold_sweep, hierarchical_sweep, replicated_sweep
from multimodalsignal_tpu_torch.parallel.fold_sweep import (
    FoldSweep,
    build_fold_batch,
    fold_streams,
    grid_steps,
    seed_group_streams,
    stage_corpus,
)
from multimodalsignal_tpu_torch.parallel.replicated_sweep import replicate_fold_batch
from multimodalsignal_tpu_torch.serving import PredictionService, make_server
from multimodalsignal_tpu_torch.train.checkpoints import (
    read_flax_checkpoint,
    write_initial_train_state,
)
from multimodalsignal_tpu_torch.train.optim import make_optimizer
from multimodalsignal_tpu_torch.train.trainer import Trainer, batch_indices, take

# H100 SXM peaks (NVIDIA data sheet, dense): device memory bytes/s, and
# FLOP/s by the type of the recurrent product's operands (float32 outside
# the tensor cores; bfloat16 on them).
MEM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# Gate math per hidden unit and step: 3 bias adds of hg, 3 pre-activation
# adds, r * hn, two sigmoids and a tanh (4 each), (1 - z) * n + z * h (3).
GATE_FLOPS_PER_UNIT = 22
# The adjoint recomputes that gate math and adds its own per unit and step:
# dht, dz, dn, dn_pre, dr_pre, dz_pre, dhn, dht * z and the dh and db sums.
BWD_GATE_FLOPS_PER_UNIT = GATE_FLOPS_PER_UNIT + 21

SERVE_T, SERVE_B, SERVE_H = 480, 64, 64
# The default HierarchicalConfig's M2: one GRU layer of H=32 (its only layer
# is the pruned last one: a lone forward walk); and the lanes of a
# 4-seed replicated sweep of 15 folds.
M2_H, SEED_LANES = 32, 60
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=0.0, atol=0.05)}
# Adjoint kernels vs their plain versions, (dxg and dh0, dW and db) per dtype.
# float32: dxg and dh0 carry f32 round-off through 480 dependent steps in
# another summation order, so 1e-4; dW and db are sums over B*T = 30,720
# terms of magnitude up to ~1, so rtol 1e-4 with atol 1e-3. bfloat16: dxg is
# stored bf16 (one ulp of values up to ~4 is 0.03), and a one-ulp flip of a
# bf16-rounded dg moves a dW/db sum by up to ~1e-2, so atol 0.05 on dxg and
# dh0 and 0.1 with rtol 2e-2 on dW and db.
BWD_TOL = {torch.float32: (dict(rtol=1e-4, atol=1e-4), dict(rtol=1e-4, atol=1e-3)),
           torch.bfloat16: (dict(rtol=0.0, atol=0.05), dict(rtol=2e-2, atol=0.1))}
PROB_ATOL = {"float32": 1e-4, "bfloat16": 3e-2}
# TF32 as torch sets it by default (matmul off, cuDNN on), which the port's
# CLIs leave as it is; read before main() turns both off.
TF32_DEFAULTS = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
WINDOW_T = 60 * 128   # a 60 s window at 128 Hz
TRAIN_N, VAL_N, BATCH, LR = 200, 64, 64, 1e-3
# Card vs CPU over the first train steps. Losses: float32 rtol 1e-4 (f32
# round-off of a 7680-sample forward), bfloat16 rtol 2e-2. Parameters: Adam's
# first steps move each element by about +-lr whatever its gradient's size,
# so an element whose gradient sits within round-off of zero can land up to
# 2 lr per step apart; hence every element within 2 lr per step, and all but
# a small share (0.1 % f32, 10 % bf16) within 1e-5 (f32) or 2e-4 (bf16).
TRAIN_TOL = {"float32": dict(loss=1e-4, elem=1e-5, share=1e-3),
             "bfloat16": dict(loss=2e-2, elem=2e-4, share=0.1)}


def card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}")
    print(f"torch: {torch.__version__} cuda {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    return smi


PTXAS_KERNEL = re.compile(r"Function properties for (\S+)\n\s+(.*?)\n"
                          r"ptxas info\s+: Used (\d+) registers")


def short_kernel_name(mangled: str) -> str:
    """`gru_walk_kernel<float, LaneMajor, 1, 0>` from a mangled kernel name
    (template arguments: the stream type, the layout, then the integers)."""
    m = re.search(r"(gru_[a-z_]*?kernel|gru_[a-z]+_reduce)(?:I(\w*?)EEv|E)", mangled)
    if not m:
        return mangled
    rest = m.group(2) or ""
    args = {"f": ["float"], "1": ["bf16"]}.get(rest[:1], [])
    args += [rest[n.end():n.end() + int(n.group(1))] for n in re.finditer(r"NS_(\d+)", rest)]
    args += re.findall(r"L[ib](\d+)E", rest)
    return f"{m.group(1)}<{', '.join(args)}>" if args else m.group(1)


def build_phase() -> None:
    t0 = time.perf_counter()
    start_step_clock_build()
    start_grid_clock_build()
    try:
        seconds = _build.build()
    finally:
        finish_step_clock_build()
        finish_grid_clock_build()
    print(f"build: {json.dumps({k: round(v, 2) for k, v in seconds.items()})} "
          f"in {time.perf_counter() - t0:.2f} s")
    for name in seconds:
        for kernel, props, regs in PTXAS_KERNEL.findall(_build.build_log(name)):
            print(f"  ptxas {name}: {short_kernel_name(kernel)}: {regs} registers, {props}")
            if not props.endswith("0 bytes spill stores, 0 bytes spill loads"):
                raise AssertionError(f"ptxas {name}: {kernel} spills: {props}")
    check_adjoint_formulas(gru_cuda._bwd_library())
    lib = gru_cuda._library()
    for h in (M2_H, SERVE_H, 128, 136, 192):
        for bf16, size in ((0, 4), (1, 2)):
            for rows in (1, 2, 4) + ((8,) if gru_cuda.walk_in_registers(h) else ()):
                c_bytes = lib.gru_walk_shared_bytes(h, bf16, rows)
                if c_bytes != gru_cuda.walk_shared_bytes(h, size, rows):
                    raise AssertionError(
                        f"gru_walk_shared_bytes(H={h}, bf16={bf16}, rows={rows}): C says "
                        f"{c_bytes}, wrapper {gru_cuda.walk_shared_bytes(h, size, rows)}")
    for batch in (1, 5, 64, 65, 256, 1024):
        for lanes in (1, 2, 15, 60):
            for h in (M2_H, SERVE_H, 128):
                if lib.gru_walk_row_tile(batch, lanes, h, 0) != gru_cuda.walk_row_tile(batch, lanes, h):
                    raise AssertionError(f"gru_walk_row_tile({batch}, {lanes}, {h}): C says "
                                         f"{lib.gru_walk_row_tile(batch, lanes, h, 0)}")
    print(f"  gru_walk_shared_bytes(H={SERVE_H}, bf16=0, rows=1) = "
          f"{lib.gru_walk_shared_bytes(SERVE_H, 0, 1)} bytes; C and wrapper agree on the "
          "walk kernel's shared memory and row tile")


def check_adjoint_formulas(bwd) -> None:
    """The adjoint walk's (gru_bwd, gru_bwd_fb, gru_bibwd) shared memory,
    row tile, chunks of rows and workspace (at 1, 2 and 15 lanes), C against
    gru_cuda's Python twins."""
    def same(what, c_val, py_val):
        if c_val != py_val:
            raise AssertionError(f"{what}: C says {c_val}, wrapper {py_val}")

    for h in (M2_H, 40, SERVE_H, 65, 95, 109, 128, 130, 179):
        for bf16, size in ((0, 4), (1, 2)):
            for rows in (1,) + ((2,) if gru_cuda.walk_in_registers(h) else ()):
                same(f"gru_adj_shared_bytes(H={h}, bf16={bf16}, rows={rows})",
                     bwd.gru_adj_shared_bytes(h, bf16, rows),
                     gru_cuda.adj_shared_bytes(h, size, rows))
    for batch in (1, 5, 64, 65, 256, 1024):
        for lanes in (1, 2, 15, 60):
            for h in (M2_H, SERVE_H, 128):
                same(f"gru_adj_row_tile({batch}, {lanes}, {h})",
                     bwd.gru_adj_row_tile(batch, lanes, h, 0), gru_cuda.adj_row_tile(batch, lanes, h))
        for t in (1, 37, SERVE_T):
            for lanes in (1, 2, 15, 60):
                for h in (M2_H, SERVE_H, 256, 1024):
                    same(f"gru_adj_chunk_rows/partials({lanes}, {t}, {batch}, {h})",
                         (bwd.gru_adj_chunk_rows(lanes, t, batch, h),
                          bwd.gru_adj_partials(lanes, t, batch, h)),
                         gru_cuda.adj_partials(lanes, t, batch, h))
                    for size in (4, 2):
                        c_pass = gru_cuda.c_pass_plan(lanes, t, batch, h, size)
                        same(f"gru_adj_pass_plan({lanes}, {t}, {batch}, {h}, {size})", c_pass,
                             gru_cuda.adj_pass_plan(lanes, t, batch, h, size,
                                                    capacity=c_pass["capacity"]))
                same(f"gru_adj_workspace_floats({lanes}, {t}, {batch}, {SERVE_H})",
                     bwd.gru_adj_workspace_floats(lanes, t, batch, SERVE_H, 0),
                     gru_cuda.adj_workspace_floats(lanes, t, batch, SERVE_H))
    chunk, parts = gru_cuda.adj_partials(1, SERVE_T, SERVE_B, SERVE_H)
    caps = [gru_cuda.c_pass_plan(1, SERVE_T, SERVE_B, SERVE_H, size)["capacity"] for size in (4, 2)]
    print(f"  gru_adj_shared_bytes(H={SERVE_H}, bf16=0, rows=1) = "
          f"{bwd.gru_adj_shared_bytes(SERVE_H, 0, 1)} bytes; the gate pre-pass holds "
          f"{caps[0]} / {caps[1]} blocks at once (f32 / bf16); at T={SERVE_T} B={SERVE_B} "
          f"one lane: {parts} chunks of {chunk} rows, workspace "
          + ", ".join(f"{gru_cuda.adj_workspace_floats(f, SERVE_T, SERVE_B, SERVE_H) * 4 / 2**20:.1f}"
                      f" MiB at {f} lane{'s' * (f > 1)}" for f in (1, 2, 15, 60)) + "; "
          "C and wrapper agree on the adjoint walk's shared memory, row tile, chunks, "
          "the passes' grids and workspace")


def median_ms(fn, per_block: int, blocks: int = 5, warmup: int = 2) -> float:
    """ms per call: CUDA events around blocks of `per_block` back-to-back
    calls, the median over `blocks` blocks."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(blocks):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_block):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_block)
    return statistics.median(times)


def kernel_inputs(lanes, t, b, h, dtype, seed):
    """Gates N(0, 1), weights and bias U(-1/sqrt(H), 1/sqrt(H)) (torch's GRU
    init), h0 N(0, 0.5^2); drawn on the card from a torch generator seeded
    with `seed` (60 lanes of gates are 354 M values, seconds each on the
    host)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    lead = () if lanes is None else (lanes,)
    bound = 1 / math.sqrt(h)

    def normal(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    def uniform(shape):
        return (torch.rand(shape, generator=gen, device="cuda") * 2 - 1) * bound

    return (normal(lead + (t, b, 3 * h)).to(dtype), uniform(lead + (3 * h, h)).to(dtype),
            uniform(lead + (3 * h,)).to(dtype), normal(lead + (b, h), 0.5))


def bound_ms(lanes, t, b, h, dtype) -> tuple[float, str]:
    """Least time on an H100 for one call: each input read once and ys
    written once over the memory rate, or the product and gate FLOPs over
    the peak rate for the operands' type, whichever is larger."""
    f = lanes or 1
    item = torch.empty((), dtype=dtype).element_size()
    nbytes = (f * t * b * 3 * h * item + f * 3 * h * h * item + f * 3 * h * item
              + f * b * h * 4 + f * t * b * h * item)
    flops = f * t * b * (2 * h * 3 * h + GATE_FLOPS_PER_UNIT * h)
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cudnn_ms(lanes, t, b, h, dtype, calls: int = 1, per_block: int | None = None,
             blocks: int = 5) -> float:
    """nn.GRU (cuDNN) over the same T, B and H: one direction, or both for
    two lanes, called `calls` times one after another (cuDNN takes one
    weight set a call), the median of `blocks` blocks of `per_block` (by
    default max(20 // calls, 2)). It also does the input projection (input
    size H)."""
    gru = torch.nn.GRU(h, h, bidirectional=lanes == 2).to("cuda", dtype)
    gru.flatten_parameters()  # one weight buffer, as cuDNN wants it
    x = torch.randn(t, b, h, device="cuda", dtype=dtype)

    def forward():
        for _ in range(calls):
            gru(x)

    with torch.inference_mode():
        return median_ms(forward, per_block=per_block or max(20 // calls, 2), blocks=blocks)


# Shapes of the walk kernel (gru_fwd, gru_bifwd) beyond the main and the
# ragged one, as (T, B, H, dtypes): M2's H=32 (K padded to 64 in registers,
# half of it zeros), H=128 and the largest H each dtype admits (the first
# template's 135 / 190 and the formula's 136 / 192, W^T in shared memory),
# one batch row, a batch that tiles 2 or 4 rows a block, one step.
F32, BF16 = (torch.float32,), (torch.bfloat16,)
WALK_CASES = [(SERVE_T, SERVE_B, M2_H, F32 + BF16),
              (SERVE_T, SERVE_B, 128, F32 + BF16), (SERVE_T, SERVE_B, 135, F32),
              (SERVE_T, SERVE_B, 136, F32), (SERVE_T, SERVE_B, 190, BF16),
              (SERVE_T, SERVE_B, 192, BF16), (SERVE_T, 1, SERVE_H, F32 + BF16),
              (SERVE_T, 256, SERVE_H, F32 + BF16), (1, SERVE_B, SERVE_H, F32 + BF16)]


# Shapes of gru_fwd_fb (F lanes of the walk kernel) beyond the main and the
# ragged one, as (F, T, B, H, dtypes): WALK_CASES at two lanes, then 4 lanes
# at B=128 (row tile 4), 15 at B=64 (row tile 8, the fold-parallel lanes)
# at H=64 and at M2's H=32, and the 60 lanes of a 4-seed replicated sweep.
FB_CASES = [(2, *case) for case in WALK_CASES] + [
    (4, SERVE_T, 128, SERVE_H, F32 + BF16), (15, SERVE_T, SERVE_B, SERVE_H, F32 + BF16),
    (15, SERVE_T, SERVE_B, M2_H, F32 + BF16), (SEED_LANES, SERVE_T, SERVE_B, SERVE_H, F32 + BF16)]


def walk_plan(lanes: int, batch: int, hidden: int, dtype=torch.float32) -> str:
    """The walk kernel's row tile and instantiation for a shape."""
    item = itemsize(dtype)
    cluster = gru_cuda.walk_cluster_size(hidden, item)
    where = ("registers" if gru_cuda.walk_in_registers(hidden) else "shared memory"
             if cluster == 1 else f"shared memory split over a cluster of {cluster}")
    return f"row tile {gru_cuda.walk_row_tile(batch, lanes, hidden, item)}, W^T in {where}"


def kernel_phase(name, wrapper, plain, fb: bool, source_line: str) -> dict:
    lanes = 2 if fb else None
    both = (torch.float32, torch.bfloat16)
    cases = [(lanes, SERVE_T, SERVE_B, SERVE_H, both), (3 if fb else None, 37, 5, 40, both)]
    cases += FB_CASES if fb else [(None, *case) for case in WALK_CASES]
    serve_err = 0.0
    for *shape, dtypes in cases:
        for dtype in dtypes:
            for reverse in (False, True):
                args = kernel_inputs(*shape, dtype, seed=len(name) + shape[1])
                got = wrapper(*args, reverse=reverse)
                torch.cuda.synchronize()
                want = plain(*args, reverse=reverse)
                err = (got.float() - want.float()).abs().max().item()
                plan = f" ({walk_plan(shape[0] or 1, shape[2], shape[3], dtype)})"
                print(f"{name}: shape F={shape[0]} T={shape[1]} B={shape[2]} "
                      f"H={shape[3]} {str(dtype)[6:]} reverse={reverse}: "
                      f"max|d|={err:.3e}{plan}")
                if got.dtype != dtype or got.shape != want.shape:
                    raise AssertionError(f"{name}: got {got.dtype} {list(got.shape)}")
                torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
                if shape[1:] == [SERVE_T, SERVE_B, SERVE_H] and dtype == torch.float32:
                    serve_err = max(serve_err, err)
    entry = {}
    for dtype in (torch.float32, torch.bfloat16):
        args = kernel_inputs(lanes, SERVE_T, SERVE_B, SERVE_H, dtype, seed=7)
        ms = median_ms(lambda: wrapper(*args), per_block=50)
        plain_ms = median_ms(lambda: plain(*args), per_block=1, blocks=1, warmup=0)
        lib_ms = cudnn_ms(lanes, SERVE_T, SERVE_B, SERVE_H, dtype)
        b_ms, b_by = bound_ms(lanes, SERVE_T, SERVE_B, SERVE_H, dtype)
        plan = f", {walk_plan(lanes or 1, SERVE_B, SERVE_H, dtype)}"
        print(f"{name} {str(dtype)[6:]} at F={lanes or 1} T={SERVE_T} "
              f"B={SERVE_B} H={SERVE_H}: kernel {ms:.4f} ms "
              f"({ms / SERVE_T * 1e3:.3f} us per dependent step{plan}), plain "
              f"{plain_ms:.3f} ms, cuDNN GRU {lib_ms:.4f} ms, bound "
              f"{b_ms:.5f} ms ({b_by}), {b_ms / ms:.2%} of bound")
        if dtype == torch.float32:
            entry = {"name": name, "route": "cuda",
                     "source": "multimodalsignal_tpu_torch/ops/csrc/gru_fwd.cu",
                     "replaces": source_line, "launches": 0,
                     "max_abs_err": serve_err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
    return entry


# Timing-only repetitions of walk_sweep and m2_shape_timings: the median of
# 3 blocks of 10 calls (5 of 50, then 3 of 20 before; cut to keep the whole
# script inside its time limit).
SWEEP_PER_BLOCK, SWEEP_BLOCKS = 10, 3


def sweep_ms(fn) -> float:
    return median_ms(fn, per_block=SWEEP_PER_BLOCK, blocks=SWEEP_BLOCKS)


def walk_sweep() -> None:
    """The walk kernels' time at T=480, H=64 as the batch, and so the block
    count, grows, float32: one lane (gru_fwd), two (gru_bifwd), the adjoint
    walk (gru_bwd, all four of its kernels), and the F-lane adjoint
    (gru_bwd_fb) at 2 lanes, at 15 (a sweep's folds) and at 60 (a 4-seed
    replicated sweep's lanes), B=64; then the F-lane forward walk
    (gru_fwd_fb) at 15 lanes, B=64 (row tile 8), float32 and bfloat16, and
    at 60 lanes. Every line also gives the walk blocks an SM holds at once
    (CUDA's occupancy calculator) and so the waves of walk blocks. Shows
    whether the per-step cost depends on the layout or on the blocks."""
    f32, bf16 = torch.float32, torch.bfloat16
    for name, lanes, batches, dtype in (
            ("gru_fwd", 1, (16, 64, 128, 256), f32), ("gru_bifwd", 2, (32, 64, 128), f32),
            ("gru_bwd", 1, (16, 64, 128, 256), f32), ("gru_bwd_fb", 2, (SERVE_B,), f32),
            ("gru_bwd_fb", 15, (SERVE_B,), f32), ("gru_bwd_fb", SEED_LANES, (SERVE_B,), f32),
            ("gru_fwd_fb", 15, (SERVE_B,), f32), ("gru_fwd_fb", 15, (SERVE_B,), bf16),
            ("gru_fwd_fb", SEED_LANES, (SERVE_B,), f32)):
        adjoint = name.startswith("gru_bwd")
        for b in batches:
            if name == "gru_fwd":
                args = kernel_inputs(None, SERVE_T, b, SERVE_H, dtype, seed=7)
                ms = sweep_ms(lambda: gru_cuda.gru_forward(*args))
            elif name == "gru_fwd_fb":
                args = kernel_inputs(lanes, SERVE_T, b, SERVE_H, dtype, seed=7)
                ms = sweep_ms(lambda: gru_cuda.gru_forward_fb(*args))
            elif name == "gru_bifwd":
                args = fused_inputs(SERVE_T, b, SERVE_H, seed=7, adjoint=False)
                ms = sweep_ms(lambda: gru_cuda.gru_bifwd(*args))
            else:
                fb = name == "gru_bwd_fb"
                args = bwd_inputs(lanes if fb else None, SERVE_T, b, SERVE_H, dtype, seed=7)
                wrapper = gru_cuda.gru_backward_fb if fb else gru_cuda.gru_backward
                ms = sweep_ms(lambda: wrapper(*args))
            tile = gru_cuda.adj_row_tile if adjoint else gru_cuda.walk_row_tile
            rows = tile(b, lanes, SERVE_H)
            blocks = -(-b // rows) * lanes
            print(f"walk sweep: {name} {str(dtype)[6:]} F={lanes} "
                  f"T={SERVE_T} B={b} H={SERVE_H}: {ms:.4f} ms ({ms / SERVE_T * 1e3:.3f} us "
                  f"per dependent step), {blocks} blocks of row tile {rows}, "
                  + waves(adjoint, b, lanes, SERVE_H, dtype))


def waves(adjoint: bool, batch: int, lanes: int, hidden: int, dtype) -> str:
    """The walk blocks an SM holds at once (CUDA's occupancy calculator, the
    adjoint walk's or the forward walk kernel's) and the waves of walk
    blocks that follow; for the cluster walk the clusters the card holds at
    once (cudaOccupancyMaxActiveClusters) and the waves of clusters."""
    bf16, item = int(dtype == torch.bfloat16), torch.empty((), dtype=dtype).element_size()
    if adjoint:
        lib = gru_cuda._bwd_library()
        per_sm = lib.gru_adj_walk_blocks_per_sm(batch, lanes, hidden, bf16)
        at_once = lib.gru_adj_walk_active_clusters(batch, lanes, hidden, bf16)
        plan = gru_cuda.adj_plan(batch, lanes, 1, hidden, item)
    else:
        lib = gru_cuda._library()
        per_sm = lib.gru_walk_blocks_per_sm(batch, lanes, hidden, bf16)
        at_once = lib.gru_walk_active_clusters(batch, lanes, hidden, bf16)
        plan = gru_cuda.walk_plan(batch, lanes, hidden, item)
    rows, cluster = plan["rows"], plan["cluster"]
    if per_sm <= 0 or at_once <= 0:
        raise AssertionError(f"blocks per SM / clusters at once at B={batch} F={lanes} "
                             f"H={hidden}: {per_sm} / {at_once}")
    tiles = -(-batch // rows) * lanes
    if plan["instantiation"] == "grid":
        if at_once < plan["groups"]:
            raise AssertionError(f"grid walk at B={batch} F={lanes} H={hidden}: the card "
                                 f"holds {at_once} groups at once, the plan {plan['groups']}")
        return (f"{tiles} work items, groups of {cluster} CTAs ({per_sm} a SM), "
                f"{plan['groups']} at once (the card holds {at_once}): "
                f"{-(-tiles // plan['groups'])} round(s)")
    if cluster == 1:
        return f"{per_sm} a SM at once: {-(-tiles // (per_sm * gru_cuda.NUM_SMS))} wave(s)"
    return (f"{tiles} clusters of {cluster} CTAs, {per_sm} CTA a SM, {at_once} clusters at "
            f"once: {-(-tiles // at_once)} wave(s)")


def bwd_bound_ms(lanes, t, b, h, dtype, products: int = 3) -> tuple[float, str]:
    """Least time on an H100 for one adjoint call: dy, h_prev, xg read once
    and dxg written once in the stream dtype, W read once, dW, db, dh0
    written once in f32; or `products` [B, H] x [H, 3H] products a row-step
    (3: h_prev @ W^T, which the adjoint walk recomputes, h_prev^T @ dg and
    dg @ W; 2: the last two alone, 12 H^2 FLOPs) and the gate math at the
    operands' peak rate."""
    f = lanes or 1
    item = torch.empty((), dtype=dtype).element_size()
    nbytes = (f * t * b * (2 * h + 2 * 3 * h) * item + f * 3 * h * h * item
              + f * (3 * h * h + 3 * h + b * h) * 4)
    flops = f * t * b * (products * 2 * h * 3 * h + BWD_GATE_FLOPS_PER_UNIT * h)
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cudnn_bwd_ms(lanes, t, b, h, dtype, calls: int = 1, per_block: int | None = None,
                 blocks: int = 5) -> float:
    """Backward of nn.GRU (cuDNN) over the same T, B and H, one direction or
    both for two lanes, called `calls` times one after another:
    forward+backward minus forward, both with autograd on. It also computes
    the input projection's gradients."""
    bi = lanes == 2
    gru = torch.nn.GRU(h, h, bidirectional=bi).to("cuda", dtype)
    gru.flatten_parameters()
    x = torch.randn(t, b, h, device="cuda", dtype=dtype, requires_grad=True)
    g = torch.randn(t, b, h * (2 if bi else 1), device="cuda", dtype=dtype)
    per_block = per_block or max(20 // calls, 2)

    def forward():
        for _ in range(calls):
            gru(x)

    def fwd_bwd():
        for _ in range(calls):
            gru(x)[0].backward(g)

    with torch.enable_grad():
        both = median_ms(fwd_bwd, per_block=per_block, blocks=blocks)
        fwd = median_ms(forward, per_block=per_block, blocks=blocks)
    return both - fwd


def bwd_inputs(lanes, t, b, h, dtype, seed, reverse=False, last_only=False):
    """kernel_inputs, then ys from the plain forward in the walk direction
    and dy N(0, 1); with `last_only` dy is zero but at the forward's last
    step (what the last-step-pruned layer sends back)."""
    xg, w, bias, h0 = kernel_inputs(lanes, t, b, h, dtype, seed)
    lead = () if lanes is None else (lanes,)
    fwd = gru_cuda.gru_forward_fb_plain if lanes else gru_cuda.gru_forward_plain
    ys = fwd(xg, w, bias, h0, reverse)
    dy = torch.randn(lead + (t, b, h), device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(seed + 1)).to(dtype)
    if last_only:
        keep = torch.arange(t, device="cuda") == (0 if reverse else t - 1)
        dy = torch.where(keep[:, None, None], dy, torch.zeros_like(dy)).contiguous()
    return xg, w, bias, h0, ys.contiguous(), dy


# Shapes of gru_bwd (the adjoint walk) beyond the main and the ragged one,
# as (T, B, H, dtypes, last_only): M2's H=32 (K = 3H padded to 192 in
# registers), also with the dy its pruned layer sends back (zero but at the
# last step), the largest H of the first template (95 f32, 109 bf16), H=128
# (W in shared memory), one batch row, B=256 (row tile 2), one step, and a
# dy that is zero but at the forward's last step.
ADJ_CASES = [(SERVE_T, SERVE_B, M2_H, F32 + BF16, False),
             (SERVE_T, SERVE_B, M2_H, F32 + BF16, True),
             (SERVE_T, SERVE_B, 95, F32, False), (SERVE_T, SERVE_B, 109, BF16, False),
             (SERVE_T, SERVE_B, 128, F32 + BF16, False), (SERVE_T, 1, SERVE_H, F32 + BF16, False),
             (SERVE_T, 256, SERVE_H, F32 + BF16, False), (1, SERVE_B, SERVE_H, F32 + BF16, False),
             (SERVE_T, SERVE_B, SERVE_H, F32 + BF16, True)]
# gru_bwd_fb's (F, T, B, H, dtypes, last_only): ADJ_CASES at two lanes, then
# 4 lanes at B=128 and 15 at B=64 (row tile 2: 256 and 480 walk blocks), 15
# at M2's H=32 with either dy, and the 60 lanes of a 4-seed replicated
# sweep (1,920 walk blocks).
FB_ADJ_CASES = [(2, *case) for case in ADJ_CASES] + [
    (4, SERVE_T, 128, SERVE_H, F32 + BF16, False),
    (15, SERVE_T, SERVE_B, SERVE_H, F32 + BF16, False),
    (15, SERVE_T, SERVE_B, M2_H, F32 + BF16, False),
    (15, SERVE_T, SERVE_B, M2_H, F32 + BF16, True),
    (SEED_LANES, SERVE_T, SERVE_B, SERVE_H, F32 + BF16, False)]
# gru_bibwd's (T, B, H), float32 only: the first template's largest H (95),
# H=128 and the walk's largest (130, W in shared memory), one batch row,
# B=256 (row tile 2), one step.
BI_ADJ_CASES = [(SERVE_T, SERVE_B, 95), (SERVE_T, SERVE_B, 128), (SERVE_T, SERVE_B, 130),
                (SERVE_T, 1, SERVE_H), (SERVE_T, 256, SERVE_H), (1, SERVE_B, SERVE_H)]


# The adjoint's two passes over all T (the gate pre-pass and the
# weight-gradient pass) take their products on the tensor cores: 3xTF32 in
# f32, three TF32 products for one, so a third of the H100's 495 TFLOP/s;
# bf16 at its 989.
PASS_PEAK_FLOPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
PASS_KERNELS = {"pre-pass": "gru_adj_gates_kernel", "walk": "walk",
                "weight-gradient": "gru_adj_wgrad_kernel", "reduction": "gru_adj_reduce"}


def pass_bounds(lanes, t, b, h, dtype) -> dict[str, tuple[float, str]]:
    """Least time on an H100 of each pass of one adjoint call, the larger of
    its bytes over the memory rate and its [T*B, H] x [H, 3H] products (6
    T B H^2 FLOPs a lane) over PASS_PEAK_FLOPS. Pre-pass: xg, h_prev (ys),
    dy and W read once in the stream dtype, h0 in f32, the six f32 factors
    written once. Weight-gradient: four of the factors and dht read in f32,
    h_prev in the stream dtype, dxg written in the stream dtype, dW and db
    in f32."""
    f = lanes or 1
    item = torch.empty((), dtype=dtype).element_size()
    m = f * t * b
    flops = 6 * m * h * h
    nbytes = {"pre-pass": m * (5 * h * item + 6 * h * 4) + f * (3 * h * h + 3 * h) * item
              + f * b * h * 4,
              "weight-gradient": m * (5 * h * 4 + 4 * h * item) + f * (3 * h * h + 3 * h) * 4}
    out = {}
    for name, n in nbytes.items():
        t_bytes = n / MEM_BYTES_PER_S * 1e3
        t_ops = flops / PASS_PEAK_FLOPS[dtype] * 1e3
        out[name] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return out


def mm_ms(lanes, t, b, h, dtype) -> float:
    """torch.mm of [T*B, H] x [H, 3H] in the stream dtype (TF32 off), once a
    lane: a yardstick of the passes' product, not on the port's path."""
    a = torch.randn(t * b, h, device="cuda").to(dtype)
    w = torch.randn(h, 3 * h, device="cuda").to(dtype)
    calls = lanes or 1

    def run():
        for _ in range(calls):
            torch.mm(a, w)

    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return median_ms(run, per_block=max(20 // calls, 2), blocks=3, warmup=1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def adjoint_split(fn, lanes, t, b, h, dtype, what: str, calls: int = 3) -> dict[str, float]:
    """`calls` calls of an adjoint entry (fn) after a warm-up call, split by
    kernel (torch.profiler): each pass's ms a call beside its bound
    (pass_bounds) and torch.mm's time for its product (mm_ms), the walk and
    the reduction; a part's ms is the mean over the calls the trace holds it
    for (the profiler has dropped a kernel's record now and then). Returns ms
    by part (None: not in the trace)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = dict.fromkeys(PASS_KERNELS, 0.0)
    seen = dict.fromkeys(PASS_KERNELS, 0)
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        part = next((k for k, v in PASS_KERNELS.items() if v in e.name and k != "walk"),
                    "walk" if "gru_adj" in e.name else None)
        if part:
            total[part] += e.time_range.elapsed_us() / 1e3
            seen[part] += 1
    # The walk is one kernel a call but for the streamed walk's transpose.
    split = {k: total[k] / min(seen[k], calls) if seen[k] else None for k in PASS_KERNELS}
    if not any(seen.values()):
        print(f"  {what}: the profiler saw no device activity; not measured")
        return split
    bounds = pass_bounds(lanes, t, b, h, dtype)
    lib = mm_ms(lanes, t, b, h, dtype)
    print(f"  {what} F={lanes or 1} T={t} B={b} H={h} {str(dtype)[6:]}, a call by kernel "
          f"(mean of {calls}): "
          + ", ".join(f"{k} " + ("not measured" if v is None else f"{v:.4f} ms")
                      + (f" (bound {bounds[k][0]:.4f} ms, {bounds[k][1]}; "
                         f"torch.mm {lib:.4f} ms)" if k in bounds else "")
                      for k, v in split.items()))
    return split


def adj_plan(lanes: int, t: int, batch: int, hidden: int) -> str:
    """The adjoint walk's row tile, walk blocks, instantiation and chunks of
    rows."""
    where = "registers" if gru_cuda.walk_in_registers(hidden) else "shared memory"
    rows = gru_cuda.adj_row_tile(batch, lanes, hidden)
    chunk, parts = gru_cuda.adj_partials(lanes, t, batch, hidden)
    return (f"row tile {rows}, {-(-batch // rows) * lanes} walk blocks, W in {where}, "
            f"{parts} chunks of {chunk} rows a lane")


def check_deterministic(name, wrapper, args, what: str) -> None:
    """Two calls on the same inputs give the same bits of dW and db."""
    first = wrapper(*args)
    second = wrapper(*args)
    torch.cuda.synchronize()
    for o, a, b in (("dW", first[1], second[1]), ("db", first[2], second[2])):
        if not torch.equal(a, b):
            raise AssertionError(f"{name} {what}: {o} differs between two runs "
                                 f"(max |d| {(a - b).abs().max().item():.3e})")
    print(f"{name} {what}: dW and db bitwise equal over two runs")


def bwd_kernel_phase(name, wrapper, plain, fb: bool, source_line: str) -> dict:
    lanes = 2 if fb else None
    both = (torch.float32, torch.bfloat16)
    cases = [(lanes, SERVE_T, SERVE_B, SERVE_H, both, False),
             (3 if fb else None, 37, 5, 40, both, False)]
    cases += FB_ADJ_CASES if fb else [(None, *case) for case in ADJ_CASES]
    serve_err = 0.0
    outputs = ("dxg", "dW", "db", "dh0")
    for *shape, dtypes, last_only in cases:
        for dtype in dtypes:
            for reverse in (False, True):
                args = bwd_inputs(*shape, dtype, seed=len(name) + shape[1], reverse=reverse,
                                  last_only=last_only)
                got = wrapper(*args, reverse=reverse)
                torch.cuda.synchronize()
                want = plain(*args, reverse=reverse)
                errs = [(g.float() - w.float()).abs().max().item()
                        for g, w in zip(got, want)]
                plan = f" ({adj_plan(shape[0] or 1, *shape[1:])})"
                print(f"{name}: shape F={shape[0]} T={shape[1]} B={shape[2]} "
                      f"H={shape[3]} {str(dtype)[6:]} reverse={reverse}"
                      f"{' dy at the last step only' if last_only else ''}: max|d| "
                      + ", ".join(f"{o} {e:.3e}" for o, e in zip(outputs, errs)) + plan)
                for o, g, w in zip(outputs, got, want):
                    want_dt = dtype if o == "dxg" else torch.float32
                    if g.dtype != want_dt or g.shape != w.shape:
                        raise AssertionError(f"{name} {o}: got {g.dtype} {list(g.shape)}")
                    tol = BWD_TOL[dtype][o in ("dW", "db")]
                    torch.testing.assert_close(g.float(), w.float(), **tol,
                                               msg=lambda m, o=o: f"{name} {o}: {m}")
                if shape[1:] == [SERVE_T, SERVE_B, SERVE_H] and dtype == torch.float32:
                    serve_err = max(serve_err, *errs)
    entry = {}
    for dtype in (torch.float32, torch.bfloat16):
        args = bwd_inputs(lanes, SERVE_T, SERVE_B, SERVE_H, dtype, seed=7)
        check_deterministic(name, wrapper, args, str(dtype)[6:])
        ms = median_ms(lambda: wrapper(*args), per_block=50)
        plain_ms = median_ms(lambda: plain(*args), per_block=1, blocks=1, warmup=0)
        lib_ms = cudnn_bwd_ms(lanes, SERVE_T, SERVE_B, SERVE_H, dtype)
        b_ms, b_by = bwd_bound_ms(lanes, SERVE_T, SERVE_B, SERVE_H, dtype)
        print(f"{name} {str(dtype)[6:]} at F={lanes or 1} T={SERVE_T} "
              f"B={SERVE_B} H={SERVE_H}: kernel {ms:.4f} ms "
              f"({ms / SERVE_T * 1e3:.3f} us per dependent step, "
              f"{adj_plan(lanes or 1, SERVE_T, SERVE_B, SERVE_H)}), plain "
              f"{plain_ms:.3f} ms, cuDNN GRU backward {lib_ms:.4f} ms, bound "
              f"{b_ms:.5f} ms ({b_by}), {b_ms / ms:.2%} of bound")
        trace(lambda: wrapper(*args), f"{str(dtype)[6:]} {name} call")
        adjoint_split(lambda: wrapper(*args), lanes, SERVE_T, SERVE_B, SERVE_H, dtype, name)
        if dtype == torch.float32:
            entry = {"name": name, "route": "cuda",
                     "source": "multimodalsignal_tpu_torch/ops/csrc/gru_bwd.cu",
                     "replaces": source_line, "launches": 0,
                     "max_abs_err": serve_err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
    return entry


# The passes' sub-phase: (entry, lanes, H) at T=480, B=64: a sweep step's
# adjoint (15 lanes), the 4-seed replicated sweep's (60), the sweep at
# H=256, and one lane at H=1024.
PASS_SHAPES = (("gru_bwd_fb", 15, SERVE_H), ("gru_bwd_fb", SEED_LANES, SERVE_H),
               ("gru_bwd_fb", 15, 256), ("gru_bwd", 1, 1024))


def passes_phase() -> None:
    """The adjoint's two passes over all T: one call of each PASS_SHAPES
    entry in f32 and bf16 split by kernel (adjoint_split: each pass's ms,
    its bound and torch.mm's), then the pre-pass's six factors read back
    from gru_bwd_fb's workspace (gru_cuda.adj_factors_cuda, 15 lanes at H=64
    and 2 at H=256, both directions) against its plain version on the same
    inputs (ys a GRU-like state in (-1, 1)): f32 rtol = atol = 1e-5, bf16 at
    BWD_TOL's dxg tolerance."""
    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        for name, lanes, h in PASS_SHAPES:
            xg, w, bias, h0 = kernel_inputs(None if name == "gru_bwd" else lanes, SERVE_T,
                                            SERVE_B, h, dtype, seed=lanes + h)
            ys = torch.tanh(torch.randn(xg.shape[:-1] + (h,), device="cuda")).to(dtype)
            dy = torch.randn(ys.shape, device="cuda").to(dtype)
            wrapper = gru_cuda.gru_backward if name == "gru_bwd" else gru_cuda.gru_backward_fb
            adjoint_split(lambda: wrapper(xg, w, bias, h0, ys, dy), lanes, SERVE_T, SERVE_B, h,
                          dtype, f"passes {name}")
            del xg, w, bias, h0, ys, dy
            torch.cuda.empty_cache()
    for dtype in (torch.float32, torch.bfloat16):
        tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else BWD_TOL[dtype][0]
        for lanes, h in ((15, SERVE_H), (2, 256)):
            for reverse in (False, True):
                xg, w, bias, h0 = kernel_inputs(lanes, SERVE_T, SERVE_B, h, dtype, seed=h)
                ys = torch.tanh(torch.randn(xg.shape[:-1] + (h,), device="cuda")).to(dtype)
                args = (xg, w, bias, h0, ys, torch.randn(ys.shape, device="cuda").to(dtype))
                got = gru_cuda.adj_factors_cuda(*args, reverse=reverse)
                want = gru_cuda.adj_factors_plain(*args, reverse=reverse)
                torch.testing.assert_close(got, want, **tol, msg=lambda m: f"pre-pass factors: {m}")
                print(f"passes: pre-pass factors F={lanes} H={h} {str(dtype)[6:]} "
                      f"reverse={reverse}: max|d| {(got - want).abs().max().item():.3e} against "
                      f"the plain version ({tol})")
    print(f"passes: {time.perf_counter() - t0:.1f} s")


def fused_inputs(t, b, h, seed, adjoint: bool, lanes: int = 2):
    """kernel_inputs of `lanes` float32 lanes (2: one layer's directions; 2F:
    F folds') in the fused pair's layout: xg2 [T, L, B, 3H], whh2, bhh2,
    h02; for the adjoint also ys2 from the plain forward and dy2 N(0, 1)
    [T, L, B, H]."""
    xg, w, bias, h0 = kernel_inputs(lanes, t, b, h, torch.float32, seed)
    args = (xg.transpose(0, 1).contiguous(), w, bias, h0)
    del xg
    if not adjoint:
        return args
    dy2 = torch.randn((t, lanes, b, h), device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(seed + 1))
    return args + (gru_cuda.gru_bifwd_plain(*args).contiguous(), dy2)


def fused_kernel_phase(name, wrapper, plain, adjoint: bool, source_line: str) -> dict:
    """The fused BiGRU pair, float32 only: the kernel against its plain
    version at the main shape, a ragged one and WALK_CASES (gru_bifwd) or
    BI_ADJ_CASES (gru_bibwd, each direction's outputs held on their own),
    then the times (library: cuDNN's bidirectional GRU, forward or
    backward); for gru_bibwd also the dW/db determinism check and a
    profiler trace."""
    outputs = ("dxg2", "dW", "db", "dh0") if adjoint else ("ys2",)
    serve_err = 0.0
    cases = [(SERVE_T, SERVE_B, SERVE_H), (37, 5, 40)]
    cases += BI_ADJ_CASES if adjoint else [(t, b, h) for t, b, h, dtypes in WALK_CASES
                                           if torch.float32 in dtypes]
    for t, b, h in cases:
        args = fused_inputs(t, b, h, seed=len(name) + t, adjoint=adjoint)
        got = wrapper(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        got, want = (got, want) if adjoint else ((got,), (want,))
        for o, g, w in zip(outputs, got, want):
            if g.dtype != torch.float32 or g.shape != w.shape:
                raise AssertionError(f"{name} {o}: got {g.dtype} {list(g.shape)}")
        if adjoint:  # lane 1 is the backward direction: its faults show only in its own outputs
            parts = [(f" direction {d}", (got[0][:, d], *(g[d] for g in got[1:])),
                      (want[0][:, d], *(w[d] for w in want[1:]))) for d in (0, 1)]
        else:
            parts = [("", got, want)]
        plan = f" ({adj_plan(2, t, b, h) if adjoint else walk_plan(2, b, h)})"
        for part, got_d, want_d in parts:
            errs = [(g - w).abs().max().item() for g, w in zip(got_d, want_d)]
            print(f"{name}: shape T={t} B={b} H={h} float32{part}: max|d| "
                  + ", ".join(f"{o} {e:.3e}" for o, e in zip(outputs, errs)) + plan)
            for o, g, w in zip(outputs, got_d, want_d):
                tol = (BWD_TOL[torch.float32][o in ("dW", "db")] if adjoint
                       else TOL[torch.float32])
                torch.testing.assert_close(g, w, **tol,
                                           msg=lambda m, o=o: f"{name}{part} {o}: {m}")
            if (t, b, h) == (SERVE_T, SERVE_B, SERVE_H):
                serve_err = max(serve_err, *errs)
    args = fused_inputs(SERVE_T, SERVE_B, SERVE_H, seed=7, adjoint=adjoint)
    if adjoint:
        check_deterministic(name, wrapper, args, "float32")
    ms = median_ms(lambda: wrapper(*args), per_block=50)
    plain_ms = median_ms(lambda: plain(*args), per_block=1, blocks=1, warmup=0)
    shape = (2, SERVE_T, SERVE_B, SERVE_H, torch.float32)
    lib_ms = cudnn_bwd_ms(*shape) if adjoint else cudnn_ms(*shape)
    b_ms, b_by = bwd_bound_ms(*shape) if adjoint else bound_ms(*shape)
    plan = (adj_plan(2, SERVE_T, SERVE_B, SERVE_H) if adjoint
            else walk_plan(2, SERVE_B, SERVE_H))
    print(f"{name} float32 at T={SERVE_T} 2 directions B={SERVE_B} H={SERVE_H}: "
          f"kernel {ms:.4f} ms ({ms / SERVE_T * 1e3:.3f} us per dependent step, {plan}), "
          f"plain {plain_ms:.3f} ms, cuDNN bidirectional GRU "
          f"{'backward ' if adjoint else ''}{lib_ms:.4f} ms, bound {b_ms:.5f} ms "
          f"({b_by}), {b_ms / ms:.2%} of bound")
    if adjoint:
        trace(lambda: wrapper(*args), f"float32 {name} call")
        adjoint_split(lambda: wrapper(*args), 2, SERVE_T, SERVE_B, SERVE_H, torch.float32, name)
    return {"name": name, "route": "cuda",
            "source": f"multimodalsignal_tpu_torch/ops/csrc/gru_{'bwd' if adjoint else 'fwd'}.cu",
            "replaces": source_line, "launches": 0, "max_abs_err": serve_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def m2_shape_timings() -> None:
    """The kernels of a hierarchical run's M2 (H=32, one GRU layer, so the
    pruned layer's lone forward walk), at T=480, B=64, float32 and
    bfloat16: gru_fwd and gru_bwd at 1 lane (the serial M2), gru_fwd_fb and
    gru_bwd_fb at 15 lanes (its sweep and the composed evaluation), dy at
    the last step only as the pruned layer sends it: kernel ms, the bound,
    and cuDNN's one-direction nn.GRU (at 15 lanes, 15 calls)."""
    wrappers = {"gru_fwd": gru_cuda.gru_forward, "gru_fwd_fb": gru_cuda.gru_forward_fb,
                "gru_bwd": gru_cuda.gru_backward, "gru_bwd_fb": gru_cuda.gru_backward_fb}
    for name, lanes in (("gru_fwd", None), ("gru_fwd_fb", 15), ("gru_bwd", None),
                        ("gru_bwd_fb", 15)):
        adjoint = name.startswith("gru_bwd")
        for dtype in (torch.float32, torch.bfloat16):
            if adjoint:
                args = bwd_inputs(lanes, SERVE_T, SERVE_B, M2_H, dtype, seed=9, last_only=True)
                b_ms, b_by = bwd_bound_ms(lanes, SERVE_T, SERVE_B, M2_H, dtype)
                plan = adj_plan(lanes or 1, SERVE_T, SERVE_B, M2_H)
            else:
                args = kernel_inputs(lanes, SERVE_T, SERVE_B, M2_H, dtype, seed=9)
                b_ms, b_by = bound_ms(lanes, SERVE_T, SERVE_B, M2_H, dtype)
                plan = walk_plan(lanes or 1, SERVE_B, M2_H, dtype)
            ms = sweep_ms(lambda: wrappers[name](*args))
            lib_ms = (cudnn_bwd_ms if adjoint else cudnn_ms)(
                1, SERVE_T, SERVE_B, M2_H, dtype, calls=lanes or 1, blocks=SWEEP_BLOCKS)
            print(f"M2 shape: {name} {str(dtype)[6:]} F={lanes or 1} T={SERVE_T} B={SERVE_B} "
                  f"H={M2_H}: kernel {ms:.4f} ms ({ms / SERVE_T * 1e3:.3f} us per dependent "
                  f"step, {plan}, {waves(adjoint, SERVE_B, lanes or 1, M2_H, dtype)}), "
                  f"cuDNN GRU {'backward ' if adjoint else ''}{lib_ms:.4f} ms"
                  f"{f' ({lanes} calls)' if lanes else ''}, bound {b_ms:.5f} ms ({b_by}), "
                  f"{b_ms / ms:.2%} of bound")


def random_variables(cfg: ExperimentConfig, seed: int) -> dict:
    """flax-layout weights from a numpy seed: kernels and GRU weights
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), BN affine terms near 1 and 0,
    running means N(0, 0.1^2), running variances U(0.5, 2)."""
    model = build_model(cfg.model, cfg.num_classes, len(cfg.channels_to_use))
    rng = np.random.default_rng(seed)
    h = cfg.model.gru_hidden_size

    def fill(tree, path=()):
        for key, leaf in tree.items():
            if isinstance(leaf, dict):
                fill(leaf, path + (key,))
                continue
            shape = leaf.shape
            if key == "var":
                value = rng.uniform(0.5, 2.0, shape)
            elif key == "mean":
                value = rng.normal(0.0, 0.1, shape)
            elif key == "scale":
                value = rng.uniform(0.5, 1.5, shape)
            elif key == "kernel":
                fan_in = int(np.prod(shape[:-1]))
                value = rng.uniform(-1, 1, shape) / math.sqrt(fan_in)
            elif path and path[0] == "gru":
                value = rng.uniform(-1, 1, shape) / math.sqrt(h)
            else:  # dense and BN biases
                value = rng.uniform(-0.1, 0.1, shape)
            tree[key] = value.astype(np.float32)

    variables = export_jax_variables(model)
    fill(variables)
    return variables


def write_recording(path: Path, seconds: int, seed: int) -> None:
    """A WESAD-format chest recording at 700 Hz: ACC [N, 3], and ECG, EDA,
    EMG, Resp, Temp [N, 1], byte-keyed as the original pickles are."""
    rng = np.random.default_rng(seed)
    n = seconds * 700
    t = np.arange(n) / 700.0
    chan = lambda x: x[:, None].astype(np.float64)  # noqa: E731
    chest = {
        b"ACC": np.stack([np.sin(2 * np.pi * f * t) * 0.1 + rng.normal(0, 0.02, n)
                          for f in (0.3, 0.5, 0.7)], axis=1),
        b"ECG": chan(np.sin(2 * np.pi * 1.2 * t) ** 15 + rng.normal(0, 0.05, n)),
        b"EDA": chan(2.0 + 0.5 * np.sin(2 * np.pi * 0.01 * t) + rng.normal(0, 0.01, n)),
        b"EMG": chan(rng.normal(0, 0.1, n)),
        b"Resp": chan(np.sin(2 * np.pi * 0.25 * t) * 3 + rng.normal(0, 0.2, n)),
        b"Temp": chan(33.0 + rng.normal(0, 0.01, n)),
    }
    with open(path, "wb") as f:
        pickle.dump({b"signal": {b"chest": chest}}, f)


def _post(url: str, payload: dict) -> dict:
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"},
                                 method="POST")
    with urllib.request.urlopen(req, timeout=600) as resp:
        if resp.status != 200:
            raise AssertionError(f"{url}: HTTP {resp.status}")
        return json.loads(resp.read())


def _check_probs(probs, want, n: int, atol: float, what: str) -> float:
    probs = np.asarray(probs, np.float64)
    if probs.shape != (n, want.shape[1]):
        raise AssertionError(f"{what}: probs shape {probs.shape}, want {(n, want.shape[1])}")
    if not np.isfinite(probs).all() or not np.allclose(probs.sum(1), 1.0, atol=1e-5):
        raise AssertionError(f"{what}: probs not finite rows summing to 1")
    np.testing.assert_allclose(probs, want, rtol=0, atol=atol, err_msg=what)
    return float(np.abs(probs - want).max())


def trace(fn, what: str, n: int = 5) -> None:
    """torch.profiler over n back-to-back calls of fn: device time per call
    by kernel name, and the idle share (the part of the traced span from the
    first kernel's start to the last one's end with no device activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    # Device kernels only: a launch's record_function range (gru_cuda._call
    # names each launch so under a profiler) shows on the device timeline too.
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    if not spans:
        print("  trace: the profiler saw no device activity; not measured")
        return
    busy, (cur_start, cur_end) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start = start
        cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    span = spans[-1][1] - spans[0][0]
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    total = sum(by_name.values())
    print(f"  trace of {n} {what}s: device busy {total / n / 1e3:.3f} ms per "
          f"{what}, span {span / n / 1e3:.3f} ms, idle share {1 - busy / span:.2%}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"    {us / n / 1e3:8.3f} ms {us / total:6.1%}  {name[:90]}")


@contextlib.contextmanager
def tf32_as_default():
    """TF32 for matmul and cuDNN as torch's defaults set it (TF32_DEFAULTS),
    for the span of the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = TF32_DEFAULTS
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def tf32_label() -> str:
    return f"TF32 as the CLIs leave it (matmul {TF32_DEFAULTS[0]}, cuDNN {TF32_DEFAULTS[1]})"


def serving_phase(dtype: str, pkl: Path) -> dict[str, int]:
    """Drive the port's server over HTTP; returns the kernel launches of
    the run."""
    cfg = ExperimentConfig(model=ModelConfig(dtype=dtype))
    variables = random_variables(cfg, seed=0)
    predictor = Predictor(cfg, variables, device="cuda")
    # The reference runs the kernels' plain versions (gru_impl "cuda" on CPU
    # tensors), so both sides do the same arithmetic in bfloat16 too.
    ref_cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, gru_impl="cuda"))
    reference = Predictor(ref_cfg, variables, device="cpu")
    c, t = len(cfg.channels_to_use), 60 * 128
    rng = np.random.default_rng(1)
    requests = {n: rng.standard_normal((n, c, t)).astype(np.float32)
                for n in (1, 7, 64, 100)}
    service = PredictionService(predictor, batch_size=64)
    server = make_server(service, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        gru_cuda.reset_launch_counts()
        # --- the main path: everything between reset and read is counted ---
        with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
            card_info = json.loads(resp.read())
        replies = {}
        for n, x in requests.items():
            if n == 1:
                payload = {"windows": x.tolist()}
            else:
                buf = io.BytesIO()
                np.save(buf, x)
                payload = {"windows_b64": base64.b64encode(buf.getvalue()).decode()}
            replies[n] = _post(url + "/v1/predict", payload)
        rec = _post(url + "/v1/predict_recording", {"pkl_path": str(pkl)})
        launches = gru_cuda.launch_counts()
        # --------------------------------------------------------------------
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        service.close()
    if card_info["platform"] != "cuda" or card_info["window_shape"] != [c, t]:
        raise AssertionError(f"/healthz: {card_info}")
    atol = PROB_ATOL[dtype]
    errs = []
    want = {n: reference.predict_windows(x) for n, x in requests.items()}
    for n, x in requests.items():
        if replies[n]["num_windows"] != n:
            raise AssertionError(f"/v1/predict {n}: num_windows {replies[n]['num_windows']}")
        errs.append(_check_probs(replies[n]["probs"], want[n],
                                 n, atol, f"{dtype} /v1/predict {n} windows"))
    want_rec = reference.predict_recording(pkl)
    n_rec = len(want_rec.probs)
    errs.append(_check_probs([w["probs"] for w in rec["windows"]], want_rec.probs,
                             n_rec, atol, f"{dtype} /v1/predict_recording"))
    batches = sum(-(-n // 64) for n in requests) + -(-n_rec // 64)
    print(f"serving {dtype}: /healthz ok; /v1/predict 1, 7, 64, 100 windows and "
          f"/v1/predict_recording {n_rec} windows; max|probs - CPU| = "
          f"{max(errs):.3e} (atol {atol}); padded batches {batches}; "
          f"launches {launches}")
    expected = {"gru_fwd": batches, "gru_fwd_fb": batches, "gru_bwd": 0, "gru_bwd_fb": 0,
                "gru_bifwd": 0, "gru_bibwd": 0}
    if launches != expected:
        raise AssertionError(f"serving launched {launches}; expected {expected} "
                             f"for {batches} padded batches and no backward")
    if dtype == "float32":  # the same probabilities once more, TF32 as the CLIs leave it
        with tf32_as_default():
            tf32 = [np.abs(predictor.predict_windows(x) - want[n]).max()
                    for n, x in requests.items()]
            tf32.append(np.abs(predictor.predict_recording(pkl).probs - want_rec.probs).max())
        print(f"serving float32 with {tf32_label()}: max|probs - CPU| = {max(tf32):.3e}, "
              f"against {max(errs):.3e} over HTTP with TF32 off: "
              f"{'within' if max(tf32) <= atol else 'BEYOND'} atol {atol}")

    x64 = requests[64]
    xt = torch.from_numpy(x64).cuda()
    with torch.inference_mode():
        fwd_ms = median_ms(lambda: predictor.model(xt), per_block=10)
    host = []
    for _ in range(10):
        t0 = time.perf_counter()
        predictor.predict_windows(x64)
        host.append((time.perf_counter() - t0) * 1e3)
    host_ms = statistics.median(host)
    print(f"serving {dtype}: padded-64 forward {fwd_ms:.3f} ms on the device "
          f"({64 / fwd_ms * 1e3:.0f} windows/s); predict_windows(64) "
          f"{host_ms:.3f} ms host clock with copies ({64 / host_ms * 1e3:.0f} windows/s)")
    with torch.inference_mode():
        trace(lambda: predictor.model(xt), "forward")
    return launches


def check_gradients(model) -> None:
    """After one step every parameter has a finite gradient, nonzero but for
    the last layer's gru.l{L-1}_bwd_w_hh (gru.l1_bwd_w_hh at 2 layers,
    gru.l0_bwd_w_hh for a one-layer M2): with last-step pruning the final
    layer's backward direction is one cell step from h0 = 0, so dL/dW_hh =
    h0^T dg = 0 exactly (the same in the JAX model)."""
    zero_by_construction = {f"gru.l{model.gru.num_layers - 1}_bwd_w_hh"}
    for name, p in model.named_parameters():
        if p.grad is None or not torch.isfinite(p.grad).all():
            raise AssertionError(f"{name}: gradient missing or not finite")
        nonzero = bool(p.grad.abs().sum() > 0)
        if nonzero == (name in zero_by_construction):
            raise AssertionError(f"{name}: gradient {'nonzero' if nonzero else 'zero'}")
    print(f"  gradients: all {len(list(model.parameters()))} parameters finite, "
          f"nonzero but {sorted(zero_by_construction)} (zero by construction)")


def compare_steps(card, card_losses, cpu, cpu_losses, tol: dict,
                  steps: int | None = None) -> tuple:
    """(worst relative loss difference, max |parameter difference|, share
    of parameter elements beyond tol['elem'], whether all is within
    TRAIN_TOL: finite losses within tol['loss'], every element within 2 lr
    per step, at most tol['share'] beyond tol['elem']). `steps` defaults to
    one per loss (a sweep's steps give a loss per fold)."""
    steps = len(card_losses) if steps is None else steps
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses))
    worst, far, total = 0.0, 0, 0
    for (_, pa), (_, pb) in zip(card.named_parameters(), cpu.named_parameters()):
        d = (pa.detach().cpu() - pb.detach()).abs()
        worst = max(worst, d.max().item())
        far += int((d > tol["elem"]).sum())
        total += d.numel()
    share = far / total
    ok = (all(math.isfinite(v) for v in card_losses) and loss_err <= tol["loss"]
          and worst <= 2 * LR * steps + 1e-6 and share <= tol["share"])
    return loss_err, worst, share, ok


def first_steps_parity(model_cfg, variables, x, y, batches, tcfg, root: Path,
                       tol: dict, what: str, tf32_probe: bool = False) -> None:
    """Train steps on the card and on the CPU from the same weights, with
    dropout 0, over `batches` ((rows, weights) pairs): every loss within
    tol['loss'] relative, the gradients after the first step checked, and
    the parameters afterwards within TRAIN_TOL (compare_steps). The CPU
    side runs the kernels' plain versions (gru_impl "auto" would take the
    plain loop there, so it becomes "cuda"). With `tf32_probe` the card's
    steps run once more with TF32 as the CLIs leave it, and their distance
    from the CPU is printed beside the TF32-off one."""
    no_drop = dataclasses.replace(model_cfg, dropout=0.0)
    cpu_cfg = (dataclasses.replace(no_drop, gru_impl="cuda")
               if no_drop.gru_impl == "auto" else no_drop)
    c = x.shape[1]
    x_cpu, y_cpu = torch.from_numpy(x), torch.from_numpy(y.astype(np.int64))
    data = {"cpu": (x_cpu, y_cpu), "cuda": (x_cpu.cuda(), y_cpu.cuda())}

    def steps(device, cfg, name):
        trainer = Trainer(build_model(cfg, 2, c), root / name, tcfg, 2, device=device,
                          variables=variables)
        xs, ys = data[device]
        losses = []
        for k, (rows_np, w_np) in enumerate(batches):
            rows = torch.from_numpy(rows_np).to(device)
            loss, _ = trainer.train_step(xs[rows], ys[rows], torch.from_numpy(w_np).to(device))
            if k == 0 and device == "cuda":
                check_gradients(trainer.model)
            losses.append(loss.item())
        return trainer.model, losses

    cpu, cpu_losses = steps("cpu", cpu_cfg, "cpu")
    card, card_losses = steps("cuda", no_drop, "card")
    loss_err, worst, share, ok = compare_steps(card, card_losses, cpu, cpu_losses, tol)
    summary = (f"losses max rel|d| {loss_err:.3e}, parameters max|d| {worst:.3e}, "
               f"{share:.4%} beyond {tol['elem']}")
    if not ok:
        raise AssertionError(f"{what}: card vs CPU beyond TRAIN_TOL: {summary}; losses "
                             f"card {card_losses}, CPU {cpu_losses}")
    print(f"{what}: first {len(batches)} steps card vs CPU, losses "
          + ", ".join(f"{a:.6f}/{b:.6f}" for a, b in zip(card_losses, cpu_losses))
          + f"; {summary}")
    if tf32_probe:
        with tf32_as_default():
            card, card_losses = steps("cuda", no_drop, "card_tf32")
        loss_err, worst, share, ok = compare_steps(card, card_losses, cpu, cpu_losses, tol)
        print(f"{what} with {tf32_label()}: losses max rel|d| {loss_err:.3e}, parameters "
              f"max|d| {worst:.3e}, {share:.4%} beyond {tol['elem']} (TF32 off: {summary}): "
              f"{'within' if ok else 'BEYOND'} TRAIN_TOL")


def step_profile(step, windows: int, what: str) -> None:
    """ms per train step `step()` of `windows` windows (CUDA events around
    blocks of 5 back-to-back steps, the median of 3 blocks: 5 before, cut
    to keep the whole script inside its time limit), the peak device
    memory of one step (max_memory_allocated after reset_peak_memory_stats:
    what was held before the step plus what it allocated), and a profiler
    trace of back-to-back steps."""
    step_ms = median_ms(step, per_block=5, blocks=3)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"{what}: train step {step_ms:.3f} ms, {windows} windows a step "
          f"({windows / step_ms * 1e3:.0f} windows/s); peak device memory of one step "
          f"{peak / 2**20:.1f} MiB, {held / 2**20:.1f} MiB of it held before the step")
    trace(step, "train step")


def train_step_ab(impl: str, dtype: str) -> None:
    """step_profile of one tree's train step: the default model with
    gru_impl `impl`, weights from random_variables(seed 0), numpy windows
    [3, 7680] at B=64 and the config's dropout. Hold two trees against each
    other in one call through tree_ab (TF32 off there):
    cs.tree_ab(parent, out, "cs.train_step_ab('auto', 'float32')", "train_ab")."""
    cfg = ExperimentConfig(model=ModelConfig(dtype=dtype, gru_impl=impl))
    variables = random_variables(cfg, seed=0)
    rng = np.random.default_rng(3)
    xb = torch.from_numpy(rng.standard_normal((BATCH, 3, WINDOW_T)).astype(np.float32)).cuda()
    yb = torch.from_numpy(rng.integers(0, 2, BATCH)).cuda()
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(build_model(cfg.model, 2, 3), Path(tmp),
                          TrainerConfig(batch_size=BATCH, learning_rate=LR), 2, device="cuda",
                          variables=variables)
        wb = torch.ones(BATCH, device="cuda")
        step_profile(lambda: trainer.train_step(xb, yb, wb), BATCH,
                     f"A/B {Path.cwd().name} {impl} {dtype}")


def training_phase(dtype: str, root: Path) -> dict[str, int]:
    """Parity of the first steps, the Trainer run (the main path, counted),
    then timings; returns the kernel launches of the Trainer run."""
    cfg = ExperimentConfig(model=ModelConfig(dtype=dtype))
    variables = random_variables(cfg, seed=0)
    c, t = len(cfg.channels_to_use), WINDOW_T
    rng = np.random.default_rng(3)
    x_tr = rng.standard_normal((TRAIN_N, c, t)).astype(np.float32)
    y_tr = rng.integers(0, 2, TRAIN_N)
    x_va = rng.standard_normal((VAL_N, c, t)).astype(np.float32)
    y_va = rng.integers(0, 2, VAL_N)
    tcfg = TrainerConfig(epochs=2, batch_size=BATCH, learning_rate=LR)
    tol = TRAIN_TOL[dtype]

    # a. The first steps, card vs CPU, dropout 0.
    idx, w = batch_indices(TRAIN_N, BATCH, rng=np.random.default_rng(0))
    steps = [0, 1, idx.shape[0] - 1]  # two full batches and the padded last
    first_steps_parity(cfg.model, variables, x_tr, y_tr, [(idx[s], w[s]) for s in steps],
                       tcfg, root / f"parity_{dtype}", tol, f"training {dtype}",
                       tf32_probe=dtype == "float32")

    # b. The main path: Trainer.train at the config's dropout (0.5).
    trainer = Trainer(build_model(cfg.model, 2, c), root / f"train_{dtype}", tcfg, 2,
                      device="cuda", variables=variables)
    gru_cuda.reset_launch_counts()
    # --- the main path: everything between reset and read is counted ---
    trainer.train((x_tr, y_tr), (x_va, y_va))
    launches = gru_cuda.launch_counts()
    # --------------------------------------------------------------------
    train_steps = tcfg.epochs * -(-TRAIN_N // BATCH)
    eval_batches = tcfg.epochs * -(-VAL_N // BATCH)
    expected = {"gru_fwd": train_steps + eval_batches,
                "gru_fwd_fb": train_steps + eval_batches,
                "gru_bwd": train_steps, "gru_bwd_fb": train_steps,
                "gru_bifwd": 0, "gru_bibwd": 0}
    hist = trainer.history
    if not all(math.isfinite(v) for h in hist for v in (h.train_loss, h.val_loss)):
        raise AssertionError(f"training {dtype}: losses not finite: {hist}")
    if launches != expected:
        raise AssertionError(f"training {dtype}: launches {launches}, expected "
                             f"{expected} ({train_steps} train steps, "
                             f"{eval_batches} eval batches)")
    ckpt = read_flax_checkpoint(root / f"train_{dtype}" / "best_model.msgpack")
    if set(ckpt) != {"params", "batch_stats"} or not ckpt["params"]:
        raise AssertionError("best_model.msgpack did not read back")
    print(f"training {dtype}: Trainer.train {tcfg.epochs} epochs, losses "
          + ", ".join(f"{h.train_loss:.4f}/{h.val_loss:.4f}" for h in hist)
          + f" (train/val); launches {launches}")

    # c. Timings at the config's dropout: back-to-back train steps at B=64.
    xb = torch.from_numpy(x_tr[:BATCH]).cuda()
    yb = torch.from_numpy(y_tr[:BATCH]).cuda()
    wb = torch.ones(BATCH, device="cuda")
    step_profile(lambda: trainer.train_step(xb, yb, wb), BATCH,
                 f"training {dtype} dropout {cfg.model.dropout}")
    return launches


LOSO_SUBJECTS = ("S2", "S3", "S4", "S5")
LOSO_WINDOWS = 48  # per subject
FOLD_LINE = re.compile(
    r"  - test (S\d+): Accuracy = (\S+), F1-score = (\S+) \(epochs: (\d+), "
    r"best: (\d+), test loss: (\S+), (\S+)s\)")


def write_loso_data(root: Path, seed: int, subjects=LOSO_SUBJECTS) -> Path:
    """A preprocessed data directory as the preprocessor lays it out: per
    subject S*_X.npy [48, 7680, 8] float32 (the chest channels of
    ALL_CHANNEL_NAMES, N(0, 1), chest_EDA around 2) and S*_y.npy raw labels
    1-4, and _channel_names.txt."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True)
    (root / "_channel_names.txt").write_text("\n".join(ALL_CHANNEL_NAMES) + "\n")
    eda = ALL_CHANNEL_NAMES.index("chest_EDA")
    for sid in subjects:
        x = rng.standard_normal((LOSO_WINDOWS, WINDOW_T, len(ALL_CHANNEL_NAMES)),
                                dtype=np.float32)
        x[..., eda] = 2.0 + 0.5 * x[..., eda]
        np.save(root / f"{sid}_X.npy", x)
        np.save(root / f"{sid}_y.npy", rng.integers(1, 5, LOSO_WINDOWS))
    return root


def serial_steps(cfg: ExperimentConfig, windows: dict[str, int]) -> tuple[int, int]:
    """(train steps, eval batches) of a serial LOSO run whose subjects hold
    `windows` windows each: per fold and epoch one train step per batch of
    the train subjects and one eval batch per batch of the validation
    subjects, then the test subject's eval batches (stress_binary keeps
    every window; the early-stopping patience exceeds the epochs)."""
    batches = lambda n: -(-n // cfg.trainer.batch_size)  # noqa: E731
    train_steps = eval_batches = 0
    for fold in loso_folds(cfg.subjects, cfg.val_fraction, cfg.seed):
        n = lambda sids: sum(windows[s] for s in sids)  # noqa: E731
        train_steps += cfg.trainer.epochs * batches(n(fold.train_subjects))
        eval_batches += (cfg.trainer.epochs * batches(n(fold.val_subjects))
                         + batches(windows[fold.test_subject]))
    return train_steps, eval_batches


def loso_expected_launches(cfg: ExperimentConfig) -> dict[str, int]:
    """Launches a serial LOSO run over LOSO_SUBJECTS implies with the fused
    BiGRU: one of each fused kernel and of gru_fwd (the pruned last layer's
    walk) per forward, one of each adjoint per train step."""
    train_steps, eval_batches = serial_steps(cfg, dict.fromkeys(LOSO_SUBJECTS, LOSO_WINDOWS))
    return {"gru_fwd": train_steps + eval_batches, "gru_fwd_fb": 0,
            "gru_bwd": train_steps, "gru_bwd_fb": 0,
            "gru_bifwd": train_steps + eval_batches, "gru_bibwd": train_steps}


def loso_phase(dtype: str, data: Path, root: Path) -> tuple[dict[str, int], Path]:
    """First-steps parity, then the experiment CLI (the main path,
    counted), its run directory's checks and the timings; returns the
    kernel launches of the CLI run and its run directory."""
    out = root / f"loso_{dtype}"
    argv = ["--execution", "serial", "--output-dir", str(out),
            "--set", "model.gru_impl=pallas_fused", "--set", "trainer.epochs=2",
            "--set", f"model.dtype={dtype}", "--set", f"data_path={data}",
            "--set", "subjects=" + ",".join(LOSO_SUBJECTS)]
    cfg = cli.load_config(cli.build_parser().parse_args(argv))
    variables = random_variables(cfg, seed=0)
    fold = loso_folds(cfg.subjects, cfg.val_fraction, cfg.seed)[0]
    train = build_dataset(data, list(fold.train_subjects), list(cfg.channels_to_use),
                          read_channel_names(data), cfg.classification_mode,
                          cfg.normalization)
    bs = cfg.trainer.batch_size

    # a. The first 3 train steps of the first fold (its 2 batches, then the
    # first of the next epoch's order), card vs CPU, dropout 0.
    grids = [batch_indices(len(train), bs, rng=np.random.default_rng(e)) for e in (0, 1)]
    batches = [(idx[i], w[i]) for idx, w in grids for i in range(idx.shape[0])][:3]
    first_steps_parity(cfg.model, variables, train.x, train.y, batches, cfg.trainer,
                       root / f"loso_parity_{dtype}", TRAIN_TOL[dtype],
                       f"loso {dtype} fold test={fold.test_subject}")

    # b. The main path: the experiment CLI.
    gru_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    # --- the main path: everything between reset and read is counted ---
    cli.main(argv)
    launches = gru_cuda.launch_counts()
    # --------------------------------------------------------------------
    wall = time.perf_counter() - t0
    expected = loso_expected_launches(cfg)
    if launches != expected:
        raise AssertionError(f"loso {dtype}: launches {launches}, expected {expected}")
    (run_dir,) = (out / cfg.run_name).iterdir()
    saved = json.loads((run_dir / "config.json").read_text())
    if saved["model"]["gru_impl"] != "pallas_fused" or saved["model"]["dtype"] != dtype:
        raise AssertionError(f"loso {dtype}: config.json says {saved['model']}")
    summary = (run_dir / "cv_summary.txt").read_text()
    folds = FOLD_LINE.findall(summary)
    means = re.findall(r"Mean (?:accuracy|weighted F1): (\S+) ± (\S+)", summary)
    numbers = [float(v) for f in folds for v in f[1:]] + [float(v) for m in means for v in m]
    if (sorted(f[0] for f in folds) != sorted(LOSO_SUBJECTS) or len(means) != 2
            or not all(math.isfinite(v) for v in numbers)):
        raise AssertionError(f"loso {dtype}: cv_summary.txt is not 4 finite folds:\n{summary}")
    for sid in LOSO_SUBJECTS:
        ckpt = read_flax_checkpoint(run_dir / f"fold_test_on_{sid}" / "best_model.msgpack")
        if set(ckpt) != {"params", "batch_stats"} or not ckpt["params"]:
            raise AssertionError(f"loso {dtype}: fold {sid}'s best_model.msgpack did not read back")
    print(f"loso {dtype}: main --execution serial, {len(folds)} folds in {wall:.2f} s; "
          "fold wall s " + ", ".join(f"{f[0]} {f[6]}" for f in folds)
          + "; " + "; ".join(f"mean {a} ± {b}" for a, b in means)
          + f" (accuracy, F1); launches {launches}")

    # c. Timings: back-to-back pallas_fused train steps at B=64, config dropout.
    trainer = Trainer(build_model(cfg.model, 2, len(cfg.channels_to_use)),
                      root / f"loso_step_{dtype}", cfg.trainer, 2, device="cuda",
                      variables=variables)
    xb = torch.from_numpy(train.x[:bs]).cuda()
    yb = torch.from_numpy(train.y[:bs].astype(np.int64)).cuda()
    wb = torch.ones(bs, device="cuda")
    step_profile(lambda: trainer.train_step(xb, yb, wb), bs,
                 f"loso {dtype} pallas_fused dropout {cfg.model.dropout}")
    return launches, run_dir


SWEEP_FOLD_LINE = re.compile(
    r"  - test (S\d+): Accuracy = (\S+), F1-score = (\S+) \(epochs: (\d+), "
    r"best: (\d+), test loss: (\S+)\)")


# Folds of sweep_parity's CPU side: all 15 took 62.8 s (float32) and 83.8 s
# (bfloat16) on the 8 host cores beside an H100, 4 took 18-21 s a sweep on a
# slower host, where the whole script came within 11 s of its 1200 s, and 2
# took 7.4-13.4 s, seven sweeps a run, where a slower host took the whole
# script past 1200 s; so the CPU runs lane 0, held against the card's lane
# 0 (lanes are independent; lanes 0 and F-1 are also held against the
# single-fold Trainer.train_step on the card).
CPU_FOLDS = 1


def sweep_parity(cfg: ExperimentConfig, corpus, fb, root: Path, tol: dict, what: str,
                 cpu_folds: int = CPU_FOLDS) -> None:
    """With dropout 0, the first 3 sweep train steps (epoch 0's grid) of all
    F folds on the card against the port on the CPU (for auto, gru_impl
    "pallas": the F-lane kernels' plain versions, both directions with the
    walk's own reverse; any other gru_impl as it is, its kernels' plain
    versions) for the first `cpu_folds` lanes, from the same initial weights,
    under TRAIN_TOL; then lanes 0 and F-1 of the card's first step against
    the single-fold Trainer.train_step on the card with that fold's weights
    and batch (the same gru_impl; pallas_fused there walks the fused pair's
    two lanes)."""
    no_drop = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dropout=0.0))
    cpu_impl = "pallas" if cfg.model.gru_impl == "auto" else cfg.model.gru_impl
    cpu_cfg = dataclasses.replace(no_drop, model=dataclasses.replace(no_drop.model,
                                                                     gru_impl=cpu_impl))
    folds, k = len(fb.test_subjects), cpu_folds
    seeds, rngs = fold_streams(cfg.seed, folds)
    card = FoldSweep(corpus, fb, no_drop, "cuda", init_seeds=seeds)
    variables = export_jax_variables(card.model)
    first_k = dataclasses.replace(
        fb, test_subjects=fb.test_subjects[:k],
        **{name: getattr(fb, name)[:k] for name in ("train_pool", "n_train", "val_pool",
                                                    "n_val", "test_pool", "n_test")})
    cpu = FoldSweep(corpus, first_k, cpu_cfg, "cpu", init_seeds=seeds[:k])
    idx, w = card.train_grid(rngs)

    def steps(sweep):
        lanes = len(sweep.fb.test_subjects)
        idx_t, w_t = sweep.to_device((idx[:lanes], w[:lanes]))
        losses, first = [], None
        for s in range(3):
            loss, _, _ = sweep.train_step(idx_t[:, s], w_t[:, s])
            losses.append(loss.cpu().tolist())
            if s == 0:
                first = export_jax_variables(sweep.model)
        return losses, first

    t0 = time.perf_counter()
    cpu_losses, _ = steps(cpu)
    cpu_s = time.perf_counter() - t0
    card_losses, card_first = steps(card)
    card_k = FoldStackedModel([build_model(no_drop.model, cfg.num_classes,
                                           corpus.x.shape[2])] * k, no_drop.model.gru_impl)
    after = export_jax_variables(card.model)
    load_jax_variables(card_k, **stack_variables([lane_variables(after, f) for f in range(k)]))
    flat = lambda ls: [v for row in ls for v in row[:k]]  # noqa: E731
    loss_err, worst, share, ok = compare_steps(card_k, flat(card_losses), cpu.model,
                                               flat(cpu_losses), tol, steps=3)
    summary = (f"losses max rel|d| {loss_err:.3e}, parameters max|d| {worst:.3e}, "
               f"{share:.4%} beyond {tol['elem']}")
    if not ok:
        raise AssertionError(f"{what}: card vs CPU beyond TRAIN_TOL: {summary}")
    print(f"{what}: first 3 sweep steps of {folds} folds on the card, lanes 0-{k - 1} vs the "
          f"CPU ({cpu_s:.1f} s there), fold 0 losses "
          + ", ".join(f"{a[0]:.6f}/{b[0]:.6f}" for a, b in zip(card_losses, cpu_losses))
          + f"; {summary}")
    for f in (0, folds - 1):
        trainer = Trainer(build_model(no_drop.model, cfg.num_classes, corpus.x.shape[2]),
                          root / f"lane{f}", no_drop.trainer, cfg.num_classes, device="cuda",
                          variables=lane_variables(variables, f))
        rows = torch.from_numpy(idx[f, 0]).cuda()
        xs = card.x if card.feat is None else (card.x, card.feat)
        loss, _ = trainer.train_step(take(xs, rows), card.y[rows],
                                     torch.from_numpy(w[f, 0]).cuda())
        check_gradients(trainer.model)
        lane = build_model(no_drop.model, cfg.num_classes, corpus.x.shape[2])
        load_jax_variables(lane, **lane_variables(card_first, f))
        loss_err, worst, share, ok = compare_steps(trainer.model, [loss.item()], lane,
                                                   [card_losses[0][f]], tol)
        lane_summary = (f"loss rel|d| {loss_err:.3e}, parameters max|d| {worst:.3e}, "
                        f"{share:.4%} beyond {tol['elem']}")
        if not ok:
            raise AssertionError(f"{what}: lane {f} vs Trainer.train_step beyond TRAIN_TOL: "
                                 f"{lane_summary}")
        print(f"{what}: lane {f} of the card's first sweep step vs the single-fold "
              f"Trainer.train_step on the card: {lane_summary}")


KERNELS = tuple(gru_cuda.launch_counts())


def fold_walks(model_cfg: ModelConfig | None = None) -> tuple[dict[str, int], dict[str, int]]:
    """The launches of one forward and of one backward of a fold-stacked
    model, whatever its lanes: a full BiGRU layer is 2 F-lane walks
    (gru_fwd_fb; adjoint gru_bwd_fb) for auto, pallas and pallas_db, or one
    2F-lane fused walk (gru_bifwd; adjoint gru_bibwd) for pallas_fused; the
    pruned last layer is one F-lane gru_fwd_fb (adjoint gru_bwd_fb). The
    default model (2 layers, pruned, auto): 3 + 3."""
    model_cfg = model_cfg or ModelConfig()
    full = model_cfg.gru_num_layers - int(model_cfg.gru_last_prune)
    fwd, bwd = dict.fromkeys(KERNELS, 0), dict.fromkeys(KERNELS, 0)
    if FOLD_IMPLS[model_cfg.gru_impl] == "fused":
        fwd["gru_bifwd"], bwd["gru_bibwd"] = full, full
    else:
        fwd["gru_fwd_fb"], bwd["gru_bwd_fb"] = 2 * full, 2 * full
    if model_cfg.gru_last_prune:
        fwd["gru_fwd_fb"] += 1
        bwd["gru_bwd_fb"] += 1
    return fwd, bwd


def sweep_expected_launches(fb, tcfg, model_cfg: ModelConfig | None = None
                            ) -> tuple[dict[str, int], int, int]:
    """Launches the sweep implies (fold_walks of model_cfg, the default
    model's 3 F-lane walks and 3 adjoints without one) over its train steps
    and eval batches (2 epochs of train steps and validation batches, then
    the test batches; the early-stopping patience exceeds the epochs), with
    those counts. Under tcfg.remat (the default) a train step runs each
    forward walk twice (the forward, then its recompute in the backward)
    and each adjoint once."""
    b = tcfg.batch_size
    train = tcfg.epochs * grid_steps(fb.n_train, b)
    evals = tcfg.epochs * grid_steps(fb.n_val, b) + grid_steps(fb.n_test, b)
    fwd, bwd = fold_walks(model_cfg)
    forwards = train * (2 if tcfg.remat else 1) + evals
    return ({k: fwd[k] * forwards + bwd[k] * train for k in KERNELS}, train, evals)


def sweep_phase(dtype: str, data_argv: list[str], root: Path, what: str = "sweep",
                corpus=None, parity: bool = True, profile: bool = True,
                db_step: bool = True, impl: str = "auto", epochs: int = 2,
                cpu_folds: int = CPU_FOLDS, parity_batch: int | None = None
                ) -> tuple[dict[str, int], Path]:
    """First-steps parity, then the experiment CLI with no --execution (the
    sharded sweep: the main path, counted), its run directory's checks and
    the step profile (of gru_impl `impl`, and for another impl than auto
    auto's beside it; then, for auto, one pallas_db step's launches);
    returns the kernel launches of the CLI run and its run directory.
    `data_argv` names the data (--set data_path=..., the hybrid targets, or
    --from-pickles); `corpus`, if given, is what the CLI will stage from
    it; `parity_batch`, if given, the batch of the parity steps."""
    out = root / f"{what}_{dtype}"
    argv = ["--output-dir", str(out), "--set", f"trainer.epochs={epochs}",
            "--set", f"model.dtype={dtype}", "--set", f"model.gru_impl={impl}"] + data_argv
    cfg = cli.load_config(cli.build_parser().parse_args(argv))
    if corpus is None:
        staged = root / f"{what}_staged_{dtype}"
        staged.mkdir()
        corpus = stage_corpus(cfg, staged)
    fb = build_fold_batch(corpus, list(cfg.subjects), cfg.val_fraction, cfg.seed)
    folds = len(fb.test_subjects)

    # a. The first 3 sweep train steps, card vs CPU, and two lanes vs Trainer.
    if parity:
        pcfg = cfg if parity_batch is None else dataclasses.replace(
            cfg, trainer=dataclasses.replace(cfg.trainer, batch_size=parity_batch))
        sweep_parity(pcfg, corpus, fb, root / f"{what}_parity_{dtype}", TRAIN_TOL[dtype],
                     f"{what} {dtype}", cpu_folds)

    # b. The main path: the experiment CLI's default execution.
    gru_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    # --- the main path: everything between reset and read is counted ---
    cli.main(argv)
    launches = gru_cuda.launch_counts()
    # --------------------------------------------------------------------
    wall = time.perf_counter() - t0
    expected, train_steps, eval_batches = sweep_expected_launches(fb, cfg.trainer, cfg.model)
    if launches != expected:
        raise AssertionError(f"{what} {dtype}: launches {launches}, expected {expected} "
                             f"({train_steps} train steps, {eval_batches} eval batches)")
    (run_dir,) = (out / cfg.run_name).iterdir()
    saved = json.loads((run_dir / "config.json").read_text())
    if (saved["fold_execution"] != "sharded" or saved["model"]["dtype"] != dtype
            or saved["model"]["gru_impl"] != impl):
        raise AssertionError(f"{what} {dtype}: config.json says {saved}")
    summary = (run_dir / "cv_summary.txt").read_text()
    lines = SWEEP_FOLD_LINE.findall(summary)
    means = re.findall(r"Mean (?:accuracy|weighted F1): (\S+) ± (\S+)", summary)
    numbers = [float(v) for f in lines for v in f[1:]] + [float(v) for m in means for v in m]
    if (sorted(f[0] for f in lines) != sorted(cfg.subjects) or len(means) != 2
            or not all(math.isfinite(v) for v in numbers)):
        raise AssertionError(f"{what} {dtype}: cv_summary.txt is not {folds} finite folds:\n"
                             f"{summary}")
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, corpus.x.shape[2], corpus.x.shape[3])).astype(np.float32)
    if corpus.feat is not None:
        x = (x, rng.standard_normal((3, corpus.feat.shape[2])).astype(np.float32))
    for sid in cfg.subjects:
        probs = Predictor.from_run(run_dir, sid, device="cuda").predict_windows(x)
        if probs.shape != (3, 2) or not np.isfinite(probs).all():
            raise AssertionError(f"{what} {dtype}: fold {sid}'s checkpoint gives {probs}")
    print(f"{what} {dtype}: main with no --execution, {folds} folds in lockstep, "
          f"{train_steps} train steps and {eval_batches} eval batches in {wall:.2f} s; "
          + "; ".join(f"mean {a} ± {b}" for a, b in means)
          + f" (accuracy, F1); every fold's checkpoint read by Predictor; launches {launches}")

    # c. Timings at the config's dropout: back-to-back sweep steps of every
    # fold at B=64 (epoch 0's first step), gru_impl `impl` (and auto beside
    # another impl); then the walks one pallas_db step launches.
    if profile:
        seeds, rngs = fold_streams(cfg.seed, folds)
        windows = folds * cfg.trainer.batch_size
        for name in dict.fromkeys((impl, "auto")):
            c = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, gru_impl=name))
            sweep = FoldSweep(corpus, fb, c, "cuda", init_seeds=seeds)
            idx, w = sweep.to_device(sweep.train_grid(rngs))
            step_profile(lambda: sweep.train_step(idx[:, 0], w[:, 0]), windows,
                         f"{what} {dtype} {name} F={folds} dropout {cfg.model.dropout}")
        if db_step:
            db_cfg = dataclasses.replace(
                cfg, model=dataclasses.replace(cfg.model, gru_impl="pallas_db"))
            db = FoldSweep(corpus, fb, db_cfg, "cuda", variables=export_jax_variables(sweep.model))
            del sweep
            gru_cuda.reset_launch_counts()
            db.train_step(idx[:, 0], w[:, 0])
            one = gru_cuda.launch_counts()
            twice = 2 if db_cfg.trainer.remat else 1   # remat: each walk again in the backward
            if (one["gru_fwd_fb"], one["gru_bwd_fb"], sum(one.values())) != (
                    3 * twice, 3, 3 * twice + 3):
                raise AssertionError(f"{what} {dtype} pallas_db: one step launched {one}")
            print(f"{what} {dtype} pallas_db: one step launched {one} "
                  "(per-direction F-lane walks)")
            del db
        else:
            del sweep
        torch.cuda.empty_cache()
    return launches, run_dir


def serve_run_dir(run_dir: Path, requests) -> tuple[dict, list]:
    """serve_cli of `--run-dir run_dir`."""
    return serve_cli(["--run-dir", str(run_dir)], requests)


def serve_cli(args: list[str], requests) -> tuple[dict, list]:
    """Start `python -m multimodalsignal_tpu_torch.serving *args` in a
    subprocess on a free port, read its /healthz, call requests(url) and
    stop the server; returns (the /healthz reply, what requests returned)."""
    proc = subprocess.Popen([sys.executable, "-m", "multimodalsignal_tpu_torch.serving",
                             *args, "--port", "0"],
                            cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        seen = []
        for line in proc.stdout:   # the server's start-up line names its port
            seen.append(line)
            match = re.search(r"^Serving .* on (http://\S+) ", line)
            if match:
                break
        else:
            raise AssertionError(f"serving {args[0]} did not start:\n" + "".join(seen))
        url = match.group(1)
        with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
            card_info = json.loads(resp.read())
        return card_info, requests(url)
    finally:
        proc.terminate()
        proc.wait(timeout=60)


def ensemble_phase(run_dir: Path, what: str = "ensemble", serve: bool = True
                   ) -> dict[str, int]:
    """The fold ensemble of a float32 run directory (a sweep's, or a serial
    LOSO run's): the padded batches of 100 windows (the main path, counted:
    fold_walks' forward a batch, no adjoint: 3 gru_fwd_fb for auto, 1
    gru_bifwd + 1 gru_fwd_fb for pallas_fused) against the mean of the
    per-fold Predictors (atol 1e-5) and the ensemble on the CPU (PROB_ATOL);
    the padded-64 forward's time and trace; then, with `serve`, `python -m
    multimodalsignal_tpu_torch.serving --run-dir` answering one /v1/predict.
    Returns the counted launches."""
    ens = EnsemblePredictor.from_run(run_dir, device="cuda")
    folds = len(ens.fold_names)
    x = np.random.default_rng(5).standard_normal((100, 3, WINDOW_T)).astype(np.float32)
    gru_cuda.reset_launch_counts()
    # --- the main path: everything between reset and read is counted ---
    probs = ens.predict_windows(x)
    launches = gru_cuda.launch_counts()
    # --------------------------------------------------------------------
    batches = -(-len(x) // 64)
    expected = {k: v * batches for k, v in fold_walks(ens.cfg.model)[0].items()}
    if launches != expected:
        raise AssertionError(f"{what}: launches {launches}, expected {expected}")
    mean = np.mean([Predictor.from_run(run_dir, s, device="cuda").predict_windows(x)
                    for s in ens.fold_names], axis=0)
    err_mean = _check_probs(probs, mean, len(x), 1e-5, f"{what} vs mean of fold Predictors")
    cpu = EnsemblePredictor.from_run(run_dir, device="cpu").predict_windows(x)
    err_cpu = _check_probs(probs, cpu, len(x), PROB_ATOL["float32"], f"{what} vs CPU")
    print(f"{what} float32 {ens.cfg.model.gru_impl}: {folds} folds, {len(x)} windows in "
          f"{batches} padded batches; max|probs - mean of fold Predictors| = {err_mean:.3e} "
          f"(atol 1e-5), max|probs - CPU| = {err_cpu:.3e} (atol {PROB_ATOL['float32']}); "
          f"launches {launches}")
    xt = torch.from_numpy(x[:64]).cuda()
    with torch.inference_mode():
        fwd_ms = median_ms(lambda: ens.predict_tensor(xt), per_block=10)
        print(f"{what} float32: padded-64 forward of {folds} folds {fwd_ms:.3f} ms on the "
              f"device ({64 / fwd_ms * 1e3:.0f} windows/s, {64 * folds / fwd_ms * 1e3:.0f} "
              "fold-windows/s)")
        trace(lambda: ens.predict_tensor(xt), f"{what} forward")
    if not serve:
        return launches
    xs = np.random.default_rng(7).standard_normal((2, 3, WINDOW_T)).astype(np.float32)
    card_info, (reply,) = serve_run_dir(run_dir, lambda url: [
        _post(url + "/v1/predict", {"windows": xs.tolist()})])
    if (card_info["backend"] != f"checkpoint-ensemble[{folds}]"
            or card_info["platform"] != ens.device.type):
        raise AssertionError(f"serving --run-dir /healthz: {card_info}")
    err = _check_probs(reply["probs"], ens.predict_windows(xs), 2, PROB_ATOL["float32"],
                       "serving --run-dir /v1/predict")
    print(f"{what}: serving --run-dir answered /v1/predict (backend {card_info['backend']}), "
          f"max|probs - ensemble| = {err:.3e}")
    return launches


# Phase 9: WESAD pickles -> preprocessing -> --from-pickles and the hybrid
# model. Synthetic pickles of the config's 15 subjects with DEFAULT_TASKS
# (8.5 minutes each at 700 Hz, label-dependent physiology) from this seed.
PICKLE_SEED = 9


def pickles_phase(root: Path):
    """9a. Write the pickles, run the port's preprocess CLI (all three
    targets) and check its outputs; then pack_corpus_from_pickles against
    pack_corpus of the written chest_raw, bit for bit. Returns (WESAD root,
    data root, the pickle-staged corpus, windows per subject)."""
    wesad, data = root / "WESAD", root / "data"
    t0 = time.perf_counter()
    write_synthetic_wesad(wesad, list(ALL_SUBJECTS), tasks=DEFAULT_TASKS, seed=PICKLE_SEED)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    preprocess.main(["--wesad-root", str(wesad), "--output", str(data),
                     "--subjects", *ALL_SUBJECTS])
    t_pre = time.perf_counter() - t0
    raw, align, feat = (data / d for d in ("chest_raw", "chest_raw_align", "chest_feature"))
    raw_meta = {"original_fs": 700, "fs": 128, "window_sec": 60, "stride_sec": 10,
                "include_wrist": False}
    for d in (raw, align):
        if read_channel_names(d) != list(ALL_CHANNEL_NAMES) or read_preprocess_meta(d) != raw_meta:
            raise AssertionError(f"{d}: channel names or meta {read_preprocess_meta(d)}")
    if (read_feature_names(feat) != list(FEATURE_NAMES) or read_preprocess_meta(feat)
            != {"feature_extractor_version": FEATURE_EXTRACTOR_VERSION}):
        raise AssertionError(f"{feat}: feature names or meta {read_preprocess_meta(feat)}")
    counts = {}
    for sid in ALL_SUBJECTS:
        (xr, yr), (xa, ya), (xf, yf) = ((np.load(d / f"{sid}_X.npy"), np.load(d / f"{sid}_y.npy"))
                                        for d in (raw, align, feat))
        n = len(yf)
        if (xr.dtype != np.float32 or xr.shape != (len(yr), WINDOW_T, 8)
                or xa.shape != (n, WINDOW_T, 8) or xf.shape != (n, len(FEATURE_NAMES))
                or not np.array_equal(ya, yf) or not np.isfinite(xf).all()
                or not set(np.unique(yf)) <= {1, 2, 3, 4}):
            raise AssertionError(f"{sid}: raw {xr.shape}, raw-align {xa.shape}, feature "
                                 f"{xf.shape}, finite {np.isfinite(xf).all()}")
        counts[sid] = n
    channels = list(ExperimentConfig().channels_to_use)
    t0 = time.perf_counter()
    corpus, names, meta = pack_corpus_from_pickles(wesad, list(ALL_SUBJECTS), channels)
    t_pack = time.perf_counter() - t0
    two_step = pack_corpus(raw, list(ALL_SUBJECTS), channels, read_channel_names(raw))
    if (names != list(ALL_CHANNEL_NAMES) or meta != raw_meta
            or corpus.subjects != two_step.subjects
            or not all(np.array_equal(getattr(corpus, k), getattr(two_step, k))
                       for k in ("x", "y", "mask"))):
        raise AssertionError("pack_corpus_from_pickles differs from pack_corpus of chest_raw")
    size = sum(f.stat().st_size for f in wesad.rglob("*.pkl"))
    print(f"pickles: {len(counts)} subjects, {size / 2**20:.1f} MiB of pickles written in "
          f"{t_write:.2f} s; preprocess CLI (raw, raw-align, feature) {t_pre:.2f} s host; "
          f"windows per subject {counts}; features finite; pack_corpus_from_pickles "
          f"{t_pack:.2f} s, bitwise equal to pack_corpus of chest_raw")
    return wesad, data, corpus, counts


def hybrid_argv(data: Path) -> list[str]:
    return ["--set", "model.name=hybrid_cnn_gru",
            "--set", f"raw_align_path={data / 'chest_raw_align'}",
            "--set", f"feature_path={data / 'chest_feature'}"]


def hybrid_serial_phase(data: Path, root: Path, counts: dict[str, int]) -> None:
    """9d. The hybrid serial LOSO on LOSO_SUBJECTS, float32, auto, 2
    epochs: per train step one launch of each of gru_fwd_fb (layer 0's two
    directions), gru_fwd (the pruned last layer) and their adjoints, per
    eval batch one of each forward."""
    out = root / "hybrid_serial"
    argv = ["--execution", "serial", "--output-dir", str(out), "--set", "trainer.epochs=2",
            "--set", "subjects=" + ",".join(LOSO_SUBJECTS)] + hybrid_argv(data)
    cfg = cli.load_config(cli.build_parser().parse_args(argv))
    gru_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    # --- the main path: everything between reset and read is counted ---
    cli.main(argv)
    launches = gru_cuda.launch_counts()
    # --------------------------------------------------------------------
    wall = time.perf_counter() - t0
    train_steps, eval_batches = serial_steps(cfg, counts)
    expected = {"gru_fwd": train_steps + eval_batches, "gru_fwd_fb": train_steps + eval_batches,
                "gru_bwd": train_steps, "gru_bwd_fb": train_steps,
                "gru_bifwd": 0, "gru_bibwd": 0}
    if launches != expected:
        raise AssertionError(f"hybrid serial: launches {launches}, expected {expected} "
                             f"({train_steps} train steps, {eval_batches} eval batches)")
    (run_dir,) = (out / cfg.run_name).iterdir()
    saved = json.loads((run_dir / "config.json").read_text())
    if saved["preprocess_meta"].get("feature_extractor_version") != FEATURE_EXTRACTOR_VERSION:
        raise AssertionError(f"hybrid serial: config.json meta {saved['preprocess_meta']}")
    summary = (run_dir / "cv_summary.txt").read_text()
    folds = FOLD_LINE.findall(summary)
    numbers = [float(v) for f in folds for v in f[1:]]
    if sorted(f[0] for f in folds) != sorted(LOSO_SUBJECTS) or not all(
            math.isfinite(v) for v in numbers):
        raise AssertionError(f"hybrid serial: cv_summary.txt is not 4 finite folds:\n{summary}")
    for sid in LOSO_SUBJECTS:
        ckpt = run_dir / f"fold_test_on_{sid}" / "best_model.msgpack"
        if not read_flax_checkpoint(ckpt)["params"]:
            raise AssertionError(f"hybrid serial: fold {sid}'s checkpoint did not read back")
    print(f"hybrid serial float32 auto: 4 folds, {train_steps} train steps and "
          f"{eval_batches} eval batches in {wall:.2f} s; test accuracy "
          + ", ".join(f"{f[0]} {f[1]}" for f in folds) + f"; launches {launches}")


def _post_status(url: str, payload: dict) -> int:
    """The HTTP status of a POST that is expected to be refused."""
    try:
        _post(url, payload)
    except urllib.error.HTTPError as exc:
        return exc.code
    return 200


def hybrid_ensemble_phase(run_dir: Path, pkl: Path) -> None:
    """9e. The hybrid fold ensemble of the float32 hybrid sweep's run
    directory: predict_recording on a pickle of 9a (recording_to_hybrid_windows,
    the main path, counted: 3 gru_fwd_fb a padded batch) against the mean of
    the fold Predictors (atol 1e-5) and the ensemble on the CPU (PROB_ATOL);
    then `serving --run-dir` answers /v1/predict with features and refuses
    it (400) without."""
    ens = EnsemblePredictor.from_run(run_dir, device="cuda")
    folds = len(ens.fold_names)
    gru_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    # --- the main path: everything between reset and read is counted ---
    rec = ens.predict_recording(pkl)
    launches = gru_cuda.launch_counts()
    # --------------------------------------------------------------------
    host_s = time.perf_counter() - t0
    n = len(rec.probs)
    batches = -(-n // 64)
    expected = {"gru_fwd": 0, "gru_fwd_fb": 3 * batches, "gru_bwd": 0, "gru_bwd_fb": 0,
                "gru_bifwd": 0, "gru_bibwd": 0}
    if launches != expected:
        raise AssertionError(f"hybrid ensemble: launches {launches}, expected {expected}")
    pair, _ = ens.windows_from_recording(pkl)
    mean = np.mean([Predictor.from_run(run_dir, s, device="cuda").predict_windows(pair)
                    for s in ens.fold_names], axis=0)
    err_mean = _check_probs(rec.probs, mean, n, 1e-5, "hybrid ensemble vs mean of fold Predictors")
    cpu = EnsemblePredictor.from_run(run_dir, device="cpu").predict_windows(pair)
    err_cpu = _check_probs(rec.probs, cpu, n, PROB_ATOL["float32"], "hybrid ensemble vs CPU")
    print(f"hybrid ensemble float32: {folds} folds, predict_recording of {pkl.name} "
          f"({n} windows, {batches} padded batches) {host_s:.2f} s host; max|probs - mean of "
          f"fold Predictors| = {err_mean:.3e} (atol 1e-5), max|probs - CPU| = {err_cpu:.3e} "
          f"(atol {PROB_ATOL['float32']}); launches {launches}")
    xs, fs = (a[:2].tolist() for a in pair)
    card_info, (reply, refused) = serve_run_dir(run_dir, lambda url: [
        _post(url + "/v1/predict", {"windows": xs, "features": fs}),
        _post_status(url + "/v1/predict", {"windows": xs})])
    if (card_info["feature_names"] != list(FEATURE_NAMES) or refused != 400
            or card_info["backend"] != f"checkpoint-ensemble[{folds}]"):
        raise AssertionError(f"hybrid serving --run-dir: /healthz {card_info}, "
                             f"without features HTTP {refused}")
    err = _check_probs(reply["probs"], rec.probs[:2], 2, PROB_ATOL["float32"],
                       "hybrid serving --run-dir /v1/predict")
    print(f"hybrid ensemble: serving --run-dir answered /v1/predict with features "
          f"(max|probs - ensemble| = {err:.3e}) and HTTP {refused} without them")


def phase9(root: Path) -> tuple[Path, Path]:
    """Phase 9 (module docstring): 9a pickles and preprocessing, 9b the
    from-pickles sweep, 9c the hybrid sweep in float32 and bfloat16, 9d the
    hybrid serial LOSO, 9e the hybrid ensemble and its server. Returns the
    WESAD root of the pickles and the float32 hybrid sweep's run directory."""
    t_phase = time.perf_counter()
    root.mkdir()
    wesad, data, corpus, counts = pickles_phase(root)
    _, run_dir = sweep_phase("float32", ["--from-pickles", str(wesad)], root, "pickles_sweep",
                             corpus=corpus, parity=False, profile=False)
    meta = json.loads((run_dir / "config.json").read_text())["preprocess_meta"]
    if meta != from_pickles_meta(ExperimentConfig().channels_to_use)[1]:
        raise AssertionError(f"from-pickles sweep: config.json preprocess_meta {meta}")
    hybrid_run = None
    for dtype in ("float32", "bfloat16"):
        _, run = sweep_phase(dtype, hybrid_argv(data), root, "hybrid_sweep", db_step=False)
        hybrid_run = hybrid_run or run
    hybrid_serial_phase(data, root, counts)
    hybrid_ensemble_phase(hybrid_run, wesad / "S2" / "S2.pkl")
    print(f"phase 9: {time.perf_counter() - t_phase:.1f} s")
    return wesad, hybrid_run


# Phase 10: the experiments beyond plain LOSO, on phase 6, 7 and 9's
# data. The summary's per-fold line of a hierarchical run.
HIER_FOLD_LINE = re.compile(r"  - test (S\d+): M1 acc = (\S+) \| composed acc = (\S+), "
                            r"F1 = (\S+) \((\d+) windows\)")
SEEDS = (42, 43, 44, 45)
# A seed group against the single-seed sweep on the card: float32 losses as
# TRAIN_TOL (rtol 1e-4; the grouped convolutions run 4x the groups, and
# cuDNN may pick another algorithm, so round-off differs), and per fold at
# most 2 windows of a confusion matrix moved (a window whose two logits sit
# within round-off of each other flips its class: 1 leaves a cell, 1
# enters another).
SEED_GROUP_TOL = dict(loss=1e-4, cm_windows=2)


@contextlib.contextmanager
def capture_sweeps(module):
    """Collect the SweepResult of every run_fold_sweep that `module` calls
    by that name while the block runs (the results pass through unchanged)."""
    real, seen = module.run_fold_sweep, []

    def run(*args, **kwargs):
        seen.append(real(*args, **kwargs))
        return seen[-1]

    module.run_fold_sweep = run
    try:
        yield seen
    finally:
        module.run_fold_sweep = real


def sweep_profile(corpus, fb, cfg, what: str, seeds=None) -> None:
    """step_profile of the first train step of a sweep over fb (seed groups
    `seeds`, or cfg.seed) at the config's dropout."""
    seeds = seeds or (cfg.seed,)
    init, rngs = seed_group_streams(seeds, fb.train_pool.shape[0])
    sweep = FoldSweep(corpus, fb, cfg, "cuda", init_seeds=init, dropout_seeds=seeds)
    idx, w = sweep.to_device(sweep.train_grid(rngs))
    lanes = fb.train_pool.shape[0]
    step_profile(lambda: sweep.train_step(idx[:, 0], w[:, 0]), lanes * cfg.trainer.batch_size,
                 f"{what} F={lanes} dropout {cfg.model.dropout}")
    del sweep, idx, w
    torch.cuda.empty_cache()


def hier_sharded_phase(wesad: Path, root: Path, m1_impl: str = "auto",
                       stages: bool = True) -> Path:
    """10a. `main --hierarchical --from-pickles` (the sharded default), f32,
    the default HierarchicalConfig (M1 H=64 x 2 layers, M2 H=32 x 1), 15
    folds as lanes: first the 3 first M2 sweep steps card vs CPU
    (sweep_parity), then the CLI (counted: M1's sweep 3 gru_fwd_fb and 3
    gru_bwd_fb a train step, 3 gru_fwd_fb an eval batch; M2's 1, 1 and 1;
    the composed evaluation 3 + 1 gru_fwd_fb a test batch), its summary of
    15 finite folds, every stage's checkpoint read back, the step profiles
    of both sweeps. With m1_impl (13d: pallas_fused) M1 takes that gru_impl
    and its launches follow (fold_walks); `stages` False skips the M2
    parity and the step profiles. Returns the run directory."""
    out = root / f"hier_sharded_{m1_impl}"
    argv = ["--hierarchical", "--from-pickles", str(wesad), "--output-dir", str(out),
            "--set", "base.trainer.epochs=2", "--set", f"m1_model.gru_impl={m1_impl}"]
    cfg = cli.load_config(cli.build_parser().parse_args(argv))
    base = cfg.base
    union, _, _ = union_channel_indices(cfg.m1_channels, cfg.m2_channels)
    memo: dict = {}

    def staged(channels, mode):
        corpus = pack_corpus_from_pickles(wesad, list(base.subjects), list(channels), mode,
                                          base.normalization, subject_cache=memo)[0]
        return corpus, build_fold_batch(corpus, list(base.subjects), base.val_fraction,
                                        base.seed)

    def stage_cfg(channels, mode, model_cfg):
        return dataclasses.replace(base, channels_to_use=tuple(channels),
                                   classification_mode=mode, num_classes=2, model=model_cfg)

    c1, fb1 = staged(cfg.m1_channels, "stress_binary")
    c2, fb2 = staged(cfg.m2_channels, "amusement_binary")
    _, fb_u = staged(union, "ternary")
    m1_cfg = stage_cfg(cfg.m1_channels, "stress_binary", cfg.m1_model)
    m2_cfg = stage_cfg(cfg.m2_channels, "amusement_binary", cfg.m2_model)
    folds = len(fb_u.test_subjects)
    if stages:
        sweep_parity(m2_cfg, c2, fb2, root / "hier_m2_parity", TRAIN_TOL["float32"],
                     "hierarchical M2 float32 (H=32, 1 layer)")

    gru_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    # --- the main path: everything between reset and read is counted ---
    cli.main(argv)
    launches = gru_cuda.launch_counts()
    # --------------------------------------------------------------------
    wall = time.perf_counter() - t0
    expected = hier_expected_launches(cfg, fb1, fb2, fb_u)
    _, tr1, ev1 = sweep_expected_launches(fb1, base.trainer, cfg.m1_model)
    _, tr2, ev2 = sweep_expected_launches(fb2, base.trainer, cfg.m2_model)
    test_batches = grid_steps(fb_u.n_test, base.trainer.batch_size)
    if launches != expected:
        raise AssertionError(
            f"hierarchical sharded: launches {launches}, expected {expected} (M1 {tr1} train "
            f"steps, {ev1} eval batches; M2 {tr2}, {ev2}; {test_batches} composed batches)")
    (run_dir,) = (out / cfg.run_name).iterdir()
    summary = (run_dir / "hierarchical_summary.txt").read_text()
    lines = HIER_FOLD_LINE.findall(summary)
    mean = re.search(r"Mean composed accuracy: (\S+) ± (\S+)", summary)
    numbers = [float(v) for f in lines for v in f[1:4]]
    if (not summary.startswith("Hierarchical experiment summary (sharded)\n")
            or sorted(f[0] for f in lines) != sorted(base.subjects) or mean is None
            or not all(math.isfinite(v) for v in numbers + [float(mean.group(1))])):
        raise AssertionError(f"hierarchical sharded: summary is not {folds} finite folds:\n"
                             f"{summary}")
    for sid in base.subjects:
        for sub, layers in (("model_m1", cfg.m1_model.gru_num_layers),
                            ("model_m2", cfg.m2_model.gru_num_layers)):
            gru = read_flax_checkpoint(run_dir / f"fold_test_on_{sid}" / sub
                                       / "best_model.msgpack")["params"]["gru"]
            if {k.split("_")[0] for k in gru} != {f"l{i}" for i in range(layers)}:
                raise AssertionError(f"hierarchical sharded: {sid} {sub} GRU {sorted(gru)}")
    print(f"hierarchical sharded float32, M1 {m1_impl}: main --hierarchical --from-pickles, "
          f"{folds} folds "
          f"as lanes, M1 {tr1} train steps + {ev1} eval batches, M2 {tr2} + {ev2}, "
          f"{test_batches} composed test batches in {wall:.2f} s; mean composed accuracy "
          f"{mean.group(1)} ± {mean.group(2)} (not a gate); every stage's checkpoint read "
          f"back; launches {launches}")
    if stages:
        sweep_profile(c1, fb1, m1_cfg, f"hierarchical M1 float32 {m1_impl}")
        sweep_profile(c2, fb2, m2_cfg, "hierarchical M2 float32 auto (H=32, 1 layer)")
    return run_dir


def hier_expected_launches(cfg: HierarchicalConfig, fb1, fb2, fb_u) -> dict[str, int]:
    """Launches of the sharded hierarchical run: M1's sweep and M2's (each
    by sweep_expected_launches over its fold batch), then the composed
    evaluation's forwards of both stages a test batch of the union
    corpus's fold batch fb_u."""
    m1 = sweep_expected_launches(fb1, cfg.base.trainer, cfg.m1_model)[0]
    m2 = sweep_expected_launches(fb2, cfg.base.trainer, cfg.m2_model)[0]
    test_batches = grid_steps(fb_u.n_test, cfg.base.trainer.batch_size)
    f1, f2 = fold_walks(cfg.m1_model)[0], fold_walks(cfg.m2_model)[0]
    return {k: m1[k] + m2[k] + (f1[k] + f2[k]) * test_batches for k in KERNELS}


def hier_serial_expected(cfg: HierarchicalConfig, data: Path) -> dict[str, int]:
    """Launches of the serial hierarchical run on `data`: per fold M1's
    Trainer (2 layers: gru_fwd_fb and gru_fwd a forward, gru_bwd_fb and
    gru_bwd a train step) over its train steps, validation batches and test
    batches, M2's (1 layer: gru_fwd a forward, gru_bwd a train step) over
    its train steps and validation batches, and both forwards per composed
    test batch; a fold without M2 training or validation windows stops
    after M1's training."""
    base = cfg.base
    b, epochs = base.trainer.batch_size, base.trainer.epochs
    labels = {s: np.load(data / f"{s}_y.npy") for s in base.subjects}
    amuse = {s: int(np.isin(y, (1, 3)).sum()) for s, y in labels.items()}
    every = {s: len(y) for s, y in labels.items()}
    batches = lambda n: max(-(-n // b), 1)  # noqa: E731
    out = dict.fromkeys(("gru_fwd", "gru_fwd_fb", "gru_bwd", "gru_bwd_fb",
                         "gru_bifwd", "gru_bibwd"), 0)
    for fold in loso_folds(base.subjects, base.val_fraction, base.seed):
        n = lambda counts, sids: sum(counts[s] for s in sids)  # noqa: E731
        tr1 = epochs * batches(n(every, fold.train_subjects))
        ev1 = epochs * batches(n(every, fold.val_subjects))
        out["gru_fwd_fb"] += tr1 + ev1
        out["gru_fwd"] += tr1 + ev1
        out["gru_bwd_fb"] += tr1
        out["gru_bwd"] += tr1
        n2_tr, n2_va = n(amuse, fold.train_subjects), n(amuse, fold.val_subjects)
        if n2_tr == 0 or n2_va == 0:
            continue
        tr2, ev2 = epochs * batches(n2_tr), epochs * batches(n2_va)
        test = batches(every[fold.test_subject])   # M1's test batches, then the composed
        out["gru_fwd_fb"] += 2 * test
        out["gru_fwd"] += tr2 + ev2 + 3 * test
        out["gru_bwd"] += tr2
    return out


def hier_serial_phase(data: Path, root: Path) -> None:
    """10b. `main --hierarchical --execution serial` on phase 6's 4-subject
    npy data, f32, auto: one launch of each single-fold kernel of a stage a
    train step and eval batch (hier_serial_expected), a summary of 4 finite
    folds, both stages' checkpoints per fold."""
    out = root / "hier_serial"
    argv = ["--hierarchical", "--execution", "serial", "--output-dir", str(out),
            "--set", f"base.data_path={data}", "--set", "base.subjects=" + ",".join(LOSO_SUBJECTS),
            "--set", "base.trainer.epochs=2"]
    cfg = cli.load_config(cli.build_parser().parse_args(argv))
    gru_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    # --- the main path: everything between reset and read is counted ---
    cli.main(argv)
    launches = gru_cuda.launch_counts()
    # --------------------------------------------------------------------
    wall = time.perf_counter() - t0
    expected = hier_serial_expected(cfg, data)
    if launches != expected:
        raise AssertionError(f"hierarchical serial: launches {launches}, expected {expected}")
    (run_dir,) = (out / cfg.run_name).iterdir()
    summary = (run_dir / "hierarchical_summary.txt").read_text()
    lines = HIER_FOLD_LINE.findall(summary)
    if (not summary.startswith("Hierarchical experiment summary\n")
            or sorted(f[0] for f in lines) != sorted(LOSO_SUBJECTS)
            or not all(math.isfinite(float(v)) for f in lines for v in f[1:4])):
        raise AssertionError(f"hierarchical serial: summary is not 4 finite folds:\n{summary}")
    for sid in LOSO_SUBJECTS:
        for sub in ("model_m1", "model_m2"):
            if not read_flax_checkpoint(run_dir / f"fold_test_on_{sid}" / sub
                                        / "best_model.msgpack")["params"]:
                raise AssertionError(f"hierarchical serial: {sid} {sub} did not read back")
    print(f"hierarchical serial float32 auto: 4 folds in {wall:.2f} s; composed accuracy "
          + ", ".join(f"{f[0]} {f[2]}" for f in lines) + f"; launches {launches}")


def hier_predictor_phase(run_dir: Path, pkl: Path) -> None:
    """10c. HierarchicalPredictor.from_run(fold S2) on 10a's run:
    predict_recording of a phase 9 pickle (counted: a padded batch runs M1's
    gru_fwd_fb and gru_fwd and M2's gru_fwd); its labels the hard gate of
    the two stage Predictors run by hand, its probabilities their product
    (atol 1e-6) and the CPU's (PROB_ATOL); then the predict CLI with
    --run-dir --fold S2 in a subprocess."""
    hp = HierarchicalPredictor.from_run(run_dir, "S2", device="cuda")
    gru_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    # --- the main path: everything between reset and read is counted ---
    rec = hp.predict_recording(pkl)
    launches = gru_cuda.launch_counts()
    # --------------------------------------------------------------------
    host_s = time.perf_counter() - t0
    n = len(rec.labels)
    batches = -(-n // 64)
    expected = {"gru_fwd": 2 * batches, "gru_fwd_fb": batches, "gru_bwd": 0, "gru_bwd_fb": 0,
                "gru_bifwd": 0, "gru_bibwd": 0}
    if launches != expected:
        raise AssertionError(f"hierarchical predictor: launches {launches}, expected {expected}")
    x, _ = hp.windows_from_recording(pkl)
    meta = json.loads((run_dir / "config.json").read_text())["preprocess_meta"]
    stage = {}
    for sub, pred in (("model_m1", hp.m1), ("model_m2", hp.m2)):
        cols = [hp.channels.index(c) for c in pred.cfg.channels_to_use]
        stage[sub] = Predictor.from_cfg_and_checkpoint(
            pred.cfg, run_dir / "fold_test_on_S2" / sub / "best_model.msgpack", meta,
            "cuda").predict_windows(x[:, cols])
    p1, p2 = stage["model_m1"], stage["model_m2"]
    gated = np.where(p1.argmax(1) == 1, 2, p2.argmax(1))
    if not np.array_equal(rec.labels, gated):
        raise AssertionError(f"hierarchical predictor: labels {rec.labels} are not the hard "
                             f"gate of its stages {gated}")
    product = np.stack([p1[:, 0] * p2[:, 0], p1[:, 0] * p2[:, 1], p1[:, 1]], axis=1)
    err_stage = _check_probs(rec.probs, product, n, 1e-6,
                             "hierarchical predictor vs its stage Predictors")
    cpu_probs, cpu_labels = HierarchicalPredictor.from_run(
        run_dir, "S2", device="cpu").predict_windows_labeled(x)
    err_cpu = _check_probs(rec.probs, cpu_probs, n, PROB_ATOL["float32"],
                           "hierarchical predictor vs CPU")
    print(f"hierarchical predictor float32: {pkl.name} ({n} windows, {batches} padded "
          f"batches) {host_s:.2f} s host; labels the hard gate of the stage Predictors; "
          f"max|probs - stage product| = {err_stage:.3e} (atol 1e-6), max|probs - CPU| = "
          f"{err_cpu:.3e} (atol {PROB_ATOL['float32']}), labels equal to the CPU's in "
          f"{int((cpu_labels == rec.labels).sum())}/{n}; launches {launches}")
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "pred.json"
        proc = subprocess.run(
            [sys.executable, "-m", "multimodalsignal_tpu_torch.experiments.predict",
             "--run-dir", str(run_dir), "--fold", "S2", "--pkl", str(pkl), "--out", str(out)],
            cwd=Path(__file__).resolve().parent, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"predict --run-dir --fold S2: {proc.stdout}{proc.stderr}")
        got = json.loads(out.read_text())
    if ([w["label"] for w in got["windows"]] != [rec.class_names[i] for i in rec.labels]
            or got["class_names"] != list(rec.class_names)):
        raise AssertionError("predict --run-dir --fold S2: labels differ from the predictor's")
    err = _check_probs([w["probs"] for w in got["windows"]], rec.probs, n, 1e-5,
                       "predict --run-dir --fold S2")
    print(f"hierarchical predictor: `predict --run-dir --fold S2` in a subprocess, the same "
          f"labels, max|probs - predictor| = {err:.3e}")


def replicated_phase(data: Path, root: Path, single, seeds=SEEDS, impl: str = "auto",
                     profile: bool = True) -> None:
    """10d. `main --seeds 42 43 44 45` on phase 7's 15-subject data, f32:
    60 lanes (counted: 3 gru_fwd_fb and 3 gru_bwd_fb a train step, 3
    gru_fwd_fb an eval batch); seed_summary.{txt,json} and
    seed_fold_matrix.npz; seed group 0 against phase 7's single-seed sweep
    `single` under SEED_GROUP_TOL, printing whether it is bitwise; then
    step_profile at 60 lanes, f32 and bf16. 13d runs it with other `seeds`
    and gru_impl (pallas_fused: 2 x 15 folds as 60 fused lanes), launches
    by fold_walks, without the profile."""
    out = root / f"replicated_{impl}"
    argv = ["--output-dir", str(out), "--seeds", *map(str, seeds), "--set", "trainer.epochs=2",
            "--set", f"data_path={data}", "--set", f"model.gru_impl={impl}"]
    cfg = cli.load_config(cli.build_parser().parse_args(argv))
    corpus = pack_corpus(data, list(cfg.subjects), list(cfg.channels_to_use),
                         read_channel_names(data))
    fb = build_fold_batch(corpus, list(cfg.subjects), cfg.val_fraction, cfg.seed)
    folds = len(fb.test_subjects)
    with capture_sweeps(replicated_sweep) as seen:
        gru_cuda.reset_launch_counts()
        t0 = time.perf_counter()
        # --- the main path: everything between reset and read is counted ---
        cli.main(argv)
        launches = gru_cuda.launch_counts()
        # --------------------------------------------------------------------
    wall = time.perf_counter() - t0
    expected, train_steps, eval_batches = sweep_expected_launches(fb, cfg.trainer, cfg.model)
    if launches != expected:
        raise AssertionError(f"replicated {impl}: launches {launches}, expected {expected}")
    (run_dir,) = (out / cfg.run_name).iterdir()
    summary = json.loads((run_dir / "seed_summary.json").read_text())
    matrix = np.load(run_dir / "seed_fold_matrix.npz")
    text = (run_dir / "seed_summary.txt").read_text()
    if (summary["seeds"] != list(seeds) or matrix["accuracy"].shape != (len(seeds), folds)
            or not np.isfinite(matrix["accuracy"]).all()
            or not text.startswith("Seed-replicated LOSO sweep summary\n")):
        raise AssertionError(f"replicated: seed summary {summary}")
    (rep,) = seen
    group0 = slice(0, folds)
    bitwise = (all(np.array_equal(getattr(rep.history, k)[group0], getattr(single.history, k))
                   for k in rep.history._fields)
               and np.array_equal(rep.test_cm[group0], single.test_cm))
    loss_err = max(float(np.max(np.abs(getattr(rep.history, k)[group0]
                                       - getattr(single.history, k))
                                / np.maximum(np.abs(getattr(single.history, k)), 1e-12)))
                   for k in ("train_loss", "val_loss"))
    cm_moved = np.abs(rep.test_cm[group0] - single.test_cm).sum(axis=(1, 2))
    if loss_err > SEED_GROUP_TOL["loss"] or cm_moved.max() > SEED_GROUP_TOL["cm_windows"]:
        raise AssertionError(f"replicated: seed group 0 vs the single-seed sweep: losses "
                             f"rel|d| {loss_err:.3e}, confusion matrices moved {cm_moved}")
    # The seeds must train differently (on phase 7's noise labels every seed
    # may still end at the same accuracy: the majority class).
    group_loss = rep.history.train_loss.reshape(len(seeds), folds, -1)[:, :, 0].mean(axis=1)
    if len(set(group_loss.tolist())) != len(seeds):
        raise AssertionError(f"replicated: seed groups trained alike: first-epoch train "
                             f"losses {group_loss}")
    print(f"replicated float32 {impl}: main --seeds {' '.join(map(str, seeds))}, {folds} folds "
          f"x {len(seeds)} seeds = {len(seeds) * folds} folds as lanes, {train_steps} train "
          f"steps and "
          f"{eval_batches} eval batches in {wall:.2f} s; grand mean accuracy "
          f"{summary['grand_mean_accuracy']:.4f}, across-seed std of the mean "
          f"{summary['seed_std_of_mean_accuracy']:.4f}, first-epoch train loss by seed "
          + ", ".join(f"{v:.6f}" for v in group_loss) + "; seed group 0 vs the single-seed "
          "sweep: "
          f"{'bitwise equal' if bitwise else 'not bitwise'}, losses max rel|d| {loss_err:.3e}, "
          f"confusion-matrix windows moved {int(cm_moved.sum())}; launches {launches}")
    if not profile:
        return
    rfb = replicate_fold_batch(fb, len(seeds))
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dtype=dtype))
        sweep_profile(corpus, rfb, c, f"replicated {dtype} auto", seeds=SEEDS)


def ablation_phase(data: Path, root: Path) -> Path:
    """10e. The ablation CLI on phase 7's data: subsets ecg (C=1, the
    channel gate's constant path) and fusion4 (C=4, the active gate) by
    models cnn_gru_attention and cnn_gru, sharded, 2 epochs (counted: four
    sweeps of 3 + 3 a train step); ablation_summary.txt and four finite
    points. Returns the ablation's run directory."""
    out = root / "ablation"
    argv = ["--out", str(out), "--subsets", "ecg", "fusion4", "--set", "trainer.epochs=2",
            "--set", f"data_path={data}"]
    gru_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    # --- the main path: everything between reset and read is counted ---
    ablation.main(argv)
    launches = gru_cuda.launch_counts()
    # --------------------------------------------------------------------
    wall = time.perf_counter() - t0
    (run_dir,) = out.iterdir()
    cfg = config_from_dict(ExperimentConfig,
                           json.loads((run_dir / "base_config.json").read_text()))
    corpus = pack_corpus(data, list(cfg.subjects), ["chest_ECG"], read_channel_names(data))
    fb = build_fold_batch(corpus, list(cfg.subjects), cfg.val_fraction, cfg.seed)
    one, _, _ = sweep_expected_launches(fb, cfg.trainer)
    expected = {k: 4 * v for k, v in one.items()}
    if launches != expected:
        raise AssertionError(f"ablation: launches {launches}, expected {expected}")
    points = json.loads((run_dir / "ablation_results.json").read_text())
    text = (run_dir / "ablation_summary.txt").read_text()
    names = [f"{s}__{m}" for s in ("ecg", "fusion4") for m in ablation.DEFAULT_MODELS]
    if ([p["name"] for p in points] != names or not all(
            math.isfinite(p[k]) for p in points for k in ("mean_accuracy", "std_accuracy",
                                                          "mean_f1", "std_f1"))
            or not text.startswith("Ablation sweep summary")):
        raise AssertionError(f"ablation: points {points}")
    print(f"ablation float32: 2 subsets x 2 models sharded in {wall:.2f} s; "
          + ", ".join(f"{p['name']} {p['mean_accuracy']:.4f} ({p['wall_s']:.1f} s)"
                      for p in points) + f"; launches {launches}")
    return run_dir


def phase10(root: Path, wesad: Path, loso_data: Path, sweep_data: Path,
            single) -> tuple[Path, Path]:
    """Phase 10 (module docstring): 10a the sharded hierarchical CLI, 10b
    the serial one, 10c the hierarchical predictor, 10d the seed-replicated
    sweep, 10e the ablation CLI. Returns 10a's and 10e's run directories."""
    t_phase = time.perf_counter()
    root.mkdir()
    run_dir = hier_sharded_phase(wesad, root)
    hier_serial_phase(loso_data, root)
    hier_predictor_phase(run_dir, wesad / "S2" / "S2.pkl")
    replicated_phase(sweep_data, root, single)
    ablation_run = ablation_phase(sweep_data, root)
    print(f"phase 10: {time.perf_counter() - t_phase:.1f} s")
    return run_dir, ablation_run


# Phase 11: the deployment tier on phase 7, 9 and 10's runs. The stream's
# calibration span (the CLI's default) and a stdin feed's length.
STREAM_CALIB_SEC = 120
STDIN_SEC = 300
# The artifact's program is a subprocess's only code: torch, numpy and the
# standard library, run where the package cannot be imported. Then, after a
# marker line on stderr, the same artifact through ExportedPredictor (the
# package put on the path), whose load packs each GRU's weights.
ARTIFACT_ALONE = """
import io, json, sys, zipfile
import numpy as np, torch
from torch.export.passes import move_to_device_pass
path, x_path, out_path, repo = sys.argv[1:]
with zipfile.ZipFile(path) as zf:
    program = torch.export.load(io.BytesIO(zf.read("model.pt2")))
program = move_to_device_pass(program, "cuda")
torch.backends.cudnn.allow_tf32 = False
with torch.inference_mode():
    probs = program.module()(torch.from_numpy(np.load(x_path)).cuda())
np.save(out_path, probs.cpu().numpy())
leaked = sorted(n for n in sys.modules if n.startswith("multimodalsignal_tpu"))
assert not leaked, leaked
print("artifact ran alone on", torch.cuda.get_device_name(0))
print("--- ExportedPredictor ---", file=sys.stderr, flush=True)
sys.path.insert(0, repo)
from multimodalsignal_tpu_torch.experiments.export import ExportedPredictor
ExportedPredictor.load(path).predict_windows(np.load(x_path))
"""
CUDNN_COPY_WARNING = "RNN module weights are not part of single contiguous chunk"


def artifact_phase(ens_run: Path, bf16_run: Path, hybrid_run: Path, root: Path) -> Path:
    """11a. Export the 15-fold ensemble (--fold all), its fold S2, the bf16
    sweep's fold S2 and the hybrid run's fold S2; each artifact on the card
    against its Predictor (PROB_ATOL) and against itself on the CPU, for 1,
    7, 64 and 100 windows, with TF32 off and as the CLIs leave it; the
    program alone in a subprocess, then ExportedPredictor there without
    cuDNN's weight-copy warning; the padded-64 forward of artifact and
    Predictor with a trace of the artifact's; `serving --artifact`. Returns
    the ensemble artifact."""
    rng = np.random.default_rng(11)
    xs = {n: rng.standard_normal((n, 3, WINDOW_T)).astype(np.float32) for n in (1, 7, 64, 100)}
    feats = {n: rng.standard_normal((n, len(FEATURE_NAMES))).astype(np.float32) for n in xs}
    cases = [("ensemble f32", ["--run-dir", str(ens_run)],
              lambda d: EnsemblePredictor.from_run(ens_run, device=d), "float32"),
             ("fold S2 f32", ["--run-dir", str(ens_run), "--fold", "S2"],
              lambda d: Predictor.from_run(ens_run, "S2", device=d), "float32"),
             ("fold S2 bf16", ["--run-dir", str(bf16_run), "--fold", "S2"],
              lambda d: Predictor.from_run(bf16_run, "S2", device=d), "bfloat16"),
             ("hybrid S2 f32 (v2)", ["--run-dir", str(hybrid_run), "--fold", "S2"],
              lambda d: Predictor.from_run(hybrid_run, "S2", device=d), "float32")]
    ens_artifact = None
    seconds = {}
    for what, argv, predictor_on, dtype in cases:
        t0 = time.perf_counter()
        path = root / (what.split(" (")[0].replace(" ", "_") + ".mms")
        export.main(argv + ["--out", str(path)])      # the export CLI, in process
        t_export = time.perf_counter() - t0
        ens_artifact = ens_artifact or path
        ep, cpu = (ExportedPredictor.load(path, device=d) for d in ("cuda", "cpu"))
        nodes = collections.Counter(str(n.target) for n in ep.program.graph.nodes
                                    if n.op == "call_function")
        pred = predictor_on("cuda")
        if ep.meta["artifact_version"] != (2 if pred.is_hybrid else 1):
            raise AssertionError(f"artifact {what}: meta {ep.meta}")
        inputs = {n: (x, feats[n]) if pred.is_hybrid else x for n, x in xs.items()}
        atol = PROB_ATOL[dtype]
        errs, cpu_errs, tf32 = [], [], []
        for n, x in inputs.items():
            got = ep.predict_windows(x)
            want = pred.predict_windows(x)
            errs.append(_check_probs(got, want, n, atol, f"artifact {what} {n} vs Predictor"))
            cpu_errs.append(_check_probs(got, cpu.predict_windows(x), n, atol,
                                         f"artifact {what} {n} vs the CPU"))
            with tf32_as_default():
                tf32.append(_check_probs(ep.predict_windows(x), want, n, atol,
                                         f"artifact {what} {n} with {tf32_label()}"))
        print(f"artifact {what}: exported in {t_export:.2f} s ({path.stat().st_size / 2**20:.2f} "
              f"MiB, {sum(nodes.values())} call nodes, {nodes['aten.gru.input']} aten.gru, "
              f"{sum(1 for n in ep._run.graph.nodes if n.op == 'call_function')} once its GRU "
              f"weights are packed); N = 1, 7, 64, 100: max|probs - Predictor| = {max(errs):.3e}, "
              f"max|probs - CPU artifact| = {max(cpu_errs):.3e} (atol {atol}); with "
              f"{tf32_label()} {max(tf32):.3e}")
        x64 = tuple(torch.from_numpy(a).cuda() for a in
                    (inputs[64] if pred.is_hybrid else (inputs[64],)))
        with torch.inference_mode():
            art_ms = median_ms(lambda: ep.predict_tensor(*x64), per_block=10)
            pred_ms = median_ms(lambda: pred.predict_tensor(x64[0] if len(x64) == 1 else x64),
                                per_block=10)
            print(f"artifact {what}: padded-64 forward {art_ms:.3f} ms ({64 / art_ms * 1e3:.0f} "
                  f"windows/s), Predictor (hand-written kernels) {pred_ms:.3f} ms "
                  f"({64 / pred_ms * 1e3:.0f} windows/s): artifact / Predictor "
                  f"{art_ms / pred_ms:.2f}x")
            if what in ("ensemble f32", "fold S2 f32"):
                trace(lambda: ep.predict_tensor(*x64), f"artifact {what.split()[0]} forward")
        del ep, cpu, pred
        torch.cuda.empty_cache()
        seconds[what] = time.perf_counter() - t0

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        np.save(Path(tmp) / "x.npy", xs[7])
        proc = subprocess.run([sys.executable, "-c", ARTIFACT_ALONE, str(ens_artifact),
                               str(Path(tmp) / "x.npy"), str(Path(tmp) / "p.npy"),
                               str(Path(__file__).resolve().parent)],
                              cwd=tmp, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"the artifact alone: {proc.stdout}{proc.stderr}")
        alone = np.load(Path(tmp) / "p.npy")
    ens = EnsemblePredictor.from_run(ens_run, device="cuda")
    err = _check_probs(alone, ens.predict_windows(xs[7]), 7, PROB_ATOL["float32"],
                       "the ensemble artifact alone vs EnsemblePredictor")
    warned = [part.count(CUDNN_COPY_WARNING)
              for part in proc.stderr.split("--- ExportedPredictor ---")]
    print(f"artifact: {proc.stdout.strip()} in a subprocess without multimodalsignal_tpu_torch "
          f"in sys.modules; max|probs - EnsemblePredictor| = {err:.3e}; cuDNN's weight-copy "
          f"warning printed {warned[0]} times for one call there, {warned[-1]} times by "
          "ExportedPredictor after it (GRU weights packed at load)")
    if len(warned) != 2 or warned[1]:
        raise AssertionError(f"ExportedPredictor: cuDNN copied the GRU weights:\n{proc.stderr}")
    seconds["alone"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    card_info, (reply,) = serve_cli(["--artifact", str(ens_artifact)], lambda url: [
        _post(url + "/v1/predict", {"windows": xs[1].tolist()})])
    folds = len(ens.fold_names)
    if card_info["backend"] != f"artifact-ensemble[{folds}]" or card_info["platform"] != "cuda":
        raise AssertionError(f"serving --artifact /healthz: {card_info}")
    # The server process keeps torch's TF32 defaults (cuDNN's on), as every
    # CLI of the port does: hold its reply against the artifact run so here.
    with tf32_as_default():
        want = ExportedPredictor.load(ens_artifact).predict_windows(xs[1])
    err = _check_probs(reply["probs"], want, 1, 1e-6, "serving --artifact /v1/predict")
    print(f"artifact: serving --artifact answered /v1/predict (backend {card_info['backend']}), "
          f"max|probs - artifact| = {err:.3e}")
    seconds["serving --artifact"] = time.perf_counter() - t0
    print("11a: " + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()))
    return ens_artifact


@contextlib.contextmanager
def count_padded_batches():
    """The padded batches the checkpoint predictors' forwards take while the
    block runs: ceil(N / batch_size) per predict_windows (EnsemblePredictor
    and Predictor) or predict_windows_labeled (HierarchicalPredictor)."""
    seen = [0]
    reals = {cls: getattr(cls, name) for cls, name in ((Predictor, "predict_windows"),
                                                       (HierarchicalPredictor,
                                                        "predict_windows_labeled"))}

    def counting(real):
        def run(self, x, batch_size=64):
            seen[0] += -(-num_windows(x) // batch_size)
            return real(self, x, batch_size)
        return run

    Predictor.predict_windows = counting(reals[Predictor])
    HierarchicalPredictor.predict_windows_labeled = counting(reals[HierarchicalPredictor])
    try:
        yield seen
    finally:
        Predictor.predict_windows = reals[Predictor]
        HierarchicalPredictor.predict_windows_labeled = reals[HierarchicalPredictor]


def stream_cli(argv: list[str], out: Path, feed_sec: float, what: str, per_batch: dict,
               stdin_text: str | None = None) -> list[dict]:
    """`python -m multimodalsignal_tpu_torch.experiments.streaming` in process
    (the main path, counted): exactly `per_batch` launches of each kernel per
    classified padded batch; prints its events/s and real-time factor.
    Returns the events."""
    err = io.StringIO()
    saved_stdin = sys.stdin
    if stdin_text is not None:
        sys.stdin = io.StringIO(stdin_text)
    try:
        with count_padded_batches() as batches, contextlib.redirect_stderr(err):
            gru_cuda.reset_launch_counts()
            t0 = time.perf_counter()
            # --- the main path: everything between reset and read is counted ---
            streaming.main(argv + ["--out", str(out), "--calib-sec", str(STREAM_CALIB_SEC)])
            launches = gru_cuda.launch_counts()
            # --------------------------------------------------------------------
            wall = time.perf_counter() - t0
    finally:
        sys.stdin = saved_stdin
    events = [json.loads(line) for line in out.read_text().splitlines()]
    expected = {k: per_batch.get(k, 0) * batches[0] for k in launches}
    if launches != expected:
        raise AssertionError(f"stream {what}: launches {launches}, expected {expected} for "
                             f"{batches[0]} padded batches")
    probs = np.array([e["probs"] for e in events])
    if ([e["index"] for e in events] != list(range(len(events))) or not np.isfinite(probs).all()
            or not np.allclose(probs.sum(1), 1.0, atol=1e-5)):
        raise AssertionError(f"stream {what}: events out of order or probs not rows summing to 1")
    summary = err.getvalue().strip().splitlines()[-1]
    print(f"stream {what}: {len(events)} events, {batches[0]} padded batches in {wall:.2f} s "
          f"host ({len(events) / wall:.1f} events/s, {feed_sec / wall:.0f}x real time); "
          f"launches {launches}; the CLI: {summary!r}")
    return events


def frozen_stats_windows(feed: np.ndarray, feed_fs: int, channels: list[str]) -> np.ndarray:
    """The windows a stream of `feed` classifies: the causal resampler (for a
    native-rate feed), the statistics frozen on the calibration span, 60 s
    windows at a 10 s stride -> [N, C, T] (streaming.py's semantics,
    recomputed outside the stream)."""
    sig = feed
    if feed_fs != 128:
        sig = StreamingPolyResampler(feed_fs, 128, feed.shape[1]).push(feed).astype(np.float32)
    sig = sig[:, : len(channels)]
    mean, std = channel_norm_stats(sig[: STREAM_CALIB_SEC * 128], channels)
    starts = window_starts(0, len(sig), WINDOW_T, 10 * 128)
    wins = apply_channel_norm(sliding_windows(sig, starts, WINDOW_T), channels, mean, std)
    return np.ascontiguousarray(wins.transpose(0, 2, 1))


def streaming_phase(ens_run: Path, hybrid_run: Path, hier_run: Path, artifact: Path,
                    pkl: Path, root: Path) -> None:
    """11b. The mms-stream CLI: the 15-fold ensemble on the native 700 Hz
    chest feed of a phase 9 pickle (3 gru_fwd_fb a padded batch, no adjoint;
    one event a window of the recording; the events the ensemble's on the
    stream's frozen-stats windows); one fold by --checkpoint --config
    --feed resampled (1 gru_fwd_fb + 1 gru_fwd a batch); the hybrid fold S2;
    the hierarchical fold S2 (its labels the hard gate's); the ensemble
    artifact (no hand-written kernel; its events the checkpoint stream's);
    a stdin feed of 300 s at 700 Hz."""
    ens = EnsemblePredictor.from_run(ens_run, device="cuda")
    native, names = streaming._native_chest_grid(pkl)
    rec_sec = len(native) / 700
    n_windows = len(ens.windows_from_recording(pkl)[0])
    sc = streaming.StreamingClassifier.for_predictor(ens, calib_sec=STREAM_CALIB_SEC)
    feed = native[:, [names.index(c) for c in sc.feed_channels]]
    pkl_argv = ["--pkl", str(pkl)]
    events = stream_cli(["--run-dir", str(ens_run)] + pkl_argv, root / "ens.jsonl", rec_sec,
                        f"ensemble ({len(ens.fold_names)} folds), native 700 Hz feed",
                        {"gru_fwd_fb": 3})
    if len(events) != n_windows:
        raise AssertionError(f"stream ensemble: {len(events)} events for {n_windows} windows")
    want = ens.predict_windows(frozen_stats_windows(feed, 700, list(sc.channel_names)))
    err = _check_probs([e["probs"] for e in events], want, n_windows,
                       PROB_ATOL["float32"] + 1e-6, "stream ensemble vs EnsemblePredictor")
    print(f"stream ensemble: {len(events)} events = the recording's windows; max|probs - "
          f"EnsemblePredictor on the frozen-stats windows| = {err:.3e}")

    ckpt = ["--checkpoint", str(ens_run / "fold_test_on_S2" / "best_model.msgpack"),
            "--config", str(ens_run / "config.json")]
    one = stream_cli(ckpt + pkl_argv + ["--feed", "resampled"], root / "one.jsonl", rec_sec,
                     "fold S2, resampled feed", {"gru_fwd_fb": 1, "gru_fwd": 1})
    pred = Predictor.from_run(ens_run, "S2", device="cuda")
    grid, grid_names = _recording_grid(pkl, list(pred.cfg.channels_to_use), 700, 128)
    cols = [grid_names.index(c) for c in pred.cfg.channels_to_use]
    err = _check_probs([e["probs"] for e in one], pred.predict_windows(frozen_stats_windows(
        grid[:, cols].astype(np.float32), 128, list(pred.cfg.channels_to_use))), n_windows,
        PROB_ATOL["float32"] + 1e-6, "stream fold S2 vs Predictor")
    print(f"stream fold S2: max|probs - Predictor on the frozen-stats windows| = {err:.3e}")
    stream_cli(["--run-dir", str(hybrid_run), "--fold", "S2"] + pkl_argv, root / "hyb.jsonl",
               rec_sec, "hybrid fold S2, native feed", {"gru_fwd_fb": 1, "gru_fwd": 1})
    hier = stream_cli(["--run-dir", str(hier_run), "--fold", "S2"] + pkl_argv,
                      root / "hier.jsonl", rec_sec, "hierarchical fold S2, native feed",
                      {"gru_fwd_fb": 1, "gru_fwd": 2})
    hp = HierarchicalPredictor.from_run(hier_run, "S2", device="cuda")
    x = frozen_stats_windows(native[:, [names.index(c) for c in hp.channels]], 700,
                             list(hp.channels))
    p1, p2 = (stage.predict_windows(x[:, [hp.channels.index(c) for c in stage.cfg.channels_to_use]])
              for stage in (hp.m1, hp.m2))
    gated = np.where(p1.argmax(1) == 1, 2, p2.argmax(1))
    clear = (np.abs(p1[:, 1] - p1[:, 0]) > 1e-3) & (np.abs(p2[:, 1] - p2[:, 0]) > 1e-3)
    labels = np.array([hp.class_names.index(e["label"]) for e in hier])
    if len(hier) != n_windows or not np.array_equal(labels[clear], gated[clear]):
        raise AssertionError(f"stream hierarchical: labels {labels} are not the hard gate "
                             f"{gated} of its stages")
    print(f"stream hierarchical: labels the hard gate of the stage Predictors in "
          f"{int(clear.sum())}/{len(hier)} windows clear of a tie (the rest not compared)")
    art = stream_cli(["--artifact", str(artifact)] + pkl_argv, root / "art.jsonl", rec_sec,
                     "ensemble artifact, native feed", {})
    err = _check_probs([e["probs"] for e in art], np.array([e["probs"] for e in events]),
                       n_windows, PROB_ATOL["float32"] + 2e-6, "stream artifact vs ensemble stream")
    print(f"stream artifact: max|probs - the checkpoint ensemble's stream| = {err:.3e}")
    rows = (np.random.default_rng(12).standard_normal((STDIN_SEC * 700, 3)) * [1, 0.1, 1]
            + [0, 2, 0])
    text = "\n".join(",".join(f"{v:.5f}" for v in r) for r in rows)
    stdin = stream_cli(["--run-dir", str(ens_run), "--stdin", "--input-fs", "700"],
                       root / "stdin.jsonl", STDIN_SEC, f"ensemble, stdin {STDIN_SEC} s at 700 Hz",
                       {"gru_fwd_fb": 3}, stdin_text=text)
    if len(stdin) != (STDIN_SEC - 60) // 10 + 1:
        raise AssertionError(f"stream stdin: {len(stdin)} events")


def reference_model(in_channels: int, classes: int, seed: int) -> torch.nn.Module:
    """The reference CnnGruAttentionModel's topology under its module names
    (so its state_dict is a reference best_model.pt), default widths, with
    weights and batch-norm statistics from a numpy seed."""
    nn = torch.nn

    class ChannelAttention(nn.Module):
        def __init__(self, c, r=4):
            super().__init__()
            self.fc = nn.Sequential(nn.Linear(c, c // r, bias=False), nn.ReLU(),
                                    nn.Linear(c // r, c, bias=False), nn.Sigmoid())

        def forward(self, x):
            return x * self.fc(x.mean(dim=2))[:, :, None]

    class Model(nn.Module):
        def __init__(self):
            super().__init__()
            self.channel_attention = ChannelAttention(in_channels)
            self.cnn_encoder = nn.Sequential(
                nn.Conv1d(in_channels, 16, 7, stride=2, padding=3, bias=False),
                nn.BatchNorm1d(16), nn.ReLU(), nn.MaxPool1d(3, stride=2, padding=1),
                nn.Conv1d(16, 32, 5, stride=2, padding=2, bias=False),
                nn.BatchNorm1d(32), nn.ReLU(), nn.MaxPool1d(3, stride=2, padding=1))
            self.gru = nn.GRU(32, 64, 2, batch_first=True, bidirectional=True)
            self.classifier = nn.Sequential(nn.Linear(128, 64), nn.ReLU(), nn.Dropout(0.5),
                                            nn.Linear(64, classes))

        def forward(self, x):
            out, _ = self.gru(self.cnn_encoder(self.channel_attention(x)).permute(0, 2, 1))
            return self.classifier(out[:, -1])

    model = Model().eval()
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("num_batches_tracked") or t.numel() == 0:
                continue
            if name.endswith("running_var"):
                value = rng.uniform(0.5, 2.0, t.shape)
            elif name.endswith("running_mean"):
                value = rng.normal(0.0, 0.1, t.shape)
            elif name.startswith("cnn_encoder") and t.dim() == 1:   # BN scale, bias
                value = rng.uniform(0.5, 1.5, t.shape) if name.endswith("weight") else \
                    rng.uniform(-0.1, 0.1, t.shape)
            else:   # U(-1/sqrt(fan_in), 1/sqrt(fan_in)); GRU and dense biases by H
                fan_in = int(np.prod(t.shape[1:])) if t.dim() > 1 else 64
                value = rng.uniform(-1, 1, t.shape) / math.sqrt(fan_in)
            t.copy_(torch.from_numpy(value.astype(np.float32)))
    return model


def import_phase(root: Path) -> None:
    """11c. A reference best_model.pt (reference_model, default widths) ->
    the import CLI -> Predictor.from_files on the card against the reference
    model's softmax on the CPU (PROB_ATOL)."""
    channels = list(ExperimentConfig().channels_to_use)
    ref = reference_model(len(channels), 2, seed=13)
    pt = root / "best_model.pt"
    torch.save(ref.state_dict(), pt)
    out = root / "imported"
    with contextlib.redirect_stdout(io.StringIO()):
        import_torch.main(["--pt", str(pt), "--channels", *channels, "--out", str(out)])
    pred = Predictor.from_files(out / "best_model.msgpack", out / "config.json", device="cuda")
    x = np.random.default_rng(14).standard_normal((7, len(channels), WINDOW_T)).astype(np.float32)
    with torch.no_grad():
        want = torch.softmax(ref(torch.from_numpy(x)), dim=-1).numpy()
    err = _check_probs(pred.predict_windows(x), want, 7, PROB_ATOL["float32"],
                       "imported checkpoint vs the reference model")
    print(f"import: reference best_model.pt ({sum(t.numel() for t in ref.state_dict().values())} "
          f"numbers) -> import CLI -> Predictor on the card; max|probs - the reference model's "
          f"softmax on the CPU| = {err:.3e} (atol {PROB_ATOL['float32']})")


def wrist_phase(pkl: Path, root: Path) -> None:
    """11d. A random-weight checkpoint on chest_ECG, wrist_BVP, wrist_EDA:
    predict_recording of a phase 9 pickle (its wrist block resampled from
    the pickle's wrist sensors) on the card against the CPU (PROB_ATOL)."""
    cfg = ExperimentConfig(channels_to_use=("chest_ECG", "wrist_BVP", "wrist_EDA"))
    write_initial_train_state(root / "best_model.msgpack", random_variables(cfg, seed=15), 1e-3)
    save_config(cfg, root / "config.json")
    card_pred, cpu_pred = (Predictor.from_files(root / "best_model.msgpack",
                                                root / "config.json", device=d)
                           for d in ("cuda", "cpu"))
    got, want = (p.predict_recording(pkl) for p in (card_pred, cpu_pred))
    x, _ = card_pred.windows_from_recording(pkl)
    if not np.abs(x[:, 1:]).max() > 0:
        raise AssertionError("wrist: the wrist channels are empty")
    err = _check_probs(got.probs, want.probs, len(want.probs), PROB_ATOL["float32"],
                       "wrist checkpoint card vs CPU")
    print(f"wrist: chest_ECG, wrist_BVP, wrist_EDA on {pkl.name} ({len(got.probs)} windows); "
          f"max|probs - CPU| = {err:.3e} (atol {PROB_ATOL['float32']})")


def phase11(root: Path, ens_run: Path, bf16_run: Path, hybrid_run: Path, hier_run: Path,
            wesad: Path) -> None:
    """Phase 11 (module docstring): 11a export and artifacts, 11b streaming,
    11c import, 11d wrist channels."""
    t_phase = time.perf_counter()
    root.mkdir()
    pkl = wesad / "S2" / "S2.pkl"
    marks = [time.perf_counter()]
    artifact = artifact_phase(ens_run, bf16_run, hybrid_run, root)
    marks.append(time.perf_counter())
    streaming_phase(ens_run, hybrid_run, hier_run, artifact, pkl, root)
    marks.append(time.perf_counter())
    import_phase(root)
    marks.append(time.perf_counter())
    wrist_phase(pkl, root)
    marks.append(time.perf_counter())
    split = ", ".join(f"11{k} {b - a:.1f} s" for k, a, b in zip("abcd", marks, marks[1:]))
    print(f"phase 11: {time.perf_counter() - t_phase:.1f} s ({split})")


# Phase 12: mid-run resume, the sweep's profiler trace and the attention
# probe. The cut runs train RESUME_EPOCHS epochs and are cut after RESUME_CUT.
RESUME_EPOCHS, RESUME_CUT = 4, 2
PROBE_RATES, PROBE_KINDS = ("0", "0.5", "1"), ("rail", "flatline")


@contextlib.contextmanager
def timed_calls(owner, name: str):
    """The host seconds of every call of owner.<name> while the block runs
    (the calls pass through unchanged)."""
    real, seconds = getattr(owner, name), []

    def call(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return real(*args, **kwargs)
        finally:
            seconds.append(time.perf_counter() - t0)

    setattr(owner, name, call)
    try:
        yield seconds
    finally:
        setattr(owner, name, real)


def _param_leaves(tree: dict, prefix: str = ""):
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _param_leaves(tree[key], f"{prefix}{key}/")
        else:
            yield prefix + key, np.asarray(tree[key])


def _history_losses(r) -> np.ndarray:
    """A SweepResult's train and validation losses of every epoch, and its
    test loss, [F, 2 * epochs + 1]."""
    return np.concatenate([r.history.train_loss, r.history.val_loss, r.test_loss[:, None]],
                          axis=1)


def resumed_vs_uncut(got_losses, want_losses, got_params: dict, want_params: dict,
                     tol: dict, steps: int, lr: float, what: str,
                     label: str = "resumed vs uncut") -> None:
    """A resumed run against the uncut one under TRAIN_TOL (as
    compare_steps: losses within tol['loss'] relative, every parameter
    within 2 lr per step, at most tol['share'] of them beyond tol['elem']);
    prints whether the two are bitwise equal. `label` names the pair
    (phase 14: a run split over two processes against one process's)."""
    got_losses, want_losses = np.asarray(got_losses), np.asarray(want_losses)
    loss_err = float(np.max(np.abs(got_losses - want_losses)
                            / np.maximum(np.abs(want_losses), 1e-12)))
    got, want = dict(_param_leaves(got_params)), dict(_param_leaves(want_params))
    if got.keys() != want.keys():
        raise AssertionError(f"{what}: parameter trees differ")
    diffs = [np.abs(got[k] - want[k]) for k in want]
    worst = max(float(d.max()) for d in diffs)
    share = sum(int((d > tol["elem"]).sum()) for d in diffs) / sum(d.size for d in diffs)
    bitwise = (np.array_equal(got_losses, want_losses)
               and all(np.array_equal(got[k], want[k]) for k in want))
    summary = (f"losses max rel|d| {loss_err:.3e}, parameters max|d| {worst:.3e}, "
               f"{share:.4%} beyond {tol['elem']}; {'bitwise equal' if bitwise else 'not bitwise'}")
    if not (np.isfinite(got_losses).all() and loss_err <= tol["loss"]
            and worst <= 2 * lr * steps + 1e-6 and share <= tol["share"]):
        raise AssertionError(f"{what}: {label} beyond TRAIN_TOL: {summary}")
    print(f"{what}: {label} {summary}")


def repeat_vs_uncut(corpus, fb, cfg, uncut, uncut_s: float, steps: int) -> None:
    """The uncut sweep run again: bitwise equal to the first run, as the
    train steps hold cuDNN to its deterministic algorithms. Then once with
    cuDNN's default algorithms (the train steps' context replaced by a
    no-op), printing how far its atomic sums moved it from the first run
    (not checked: that drift is what the context removes) and the seconds
    of each, which are what the deterministic algorithms cost."""
    t0 = time.perf_counter()
    again = fold_sweep.run_fold_sweep(corpus, fb, cfg, "cuda")
    again_s = time.perf_counter() - t0
    got, want = dict(_param_leaves(again.final_variables["params"])), dict(
        _param_leaves(uncut.final_variables["params"]))
    if not (np.array_equal(_history_losses(again), _history_losses(uncut))
            and all(np.array_equal(got[k], want[k]) for k in want)):
        raise AssertionError("sweep float32: two uncut runs are not bitwise equal")
    deterministic = fold_sweep.deterministic_convolutions
    fold_sweep.deterministic_convolutions = contextlib.nullcontext
    try:
        t0 = time.perf_counter()
        default = fold_sweep.run_fold_sweep(corpus, fb, cfg, "cuda")
        default_s = time.perf_counter() - t0
    finally:
        fold_sweep.deterministic_convolutions = deterministic
    loss_d = float(np.max(np.abs(_history_losses(default) - _history_losses(uncut))))
    got = dict(_param_leaves(default.final_variables["params"]))
    param_d = max(float(np.max(np.abs(got[k] - want[k]))) for k in want)
    print(f"sweep float32 F={len(fb.test_subjects)}: a second uncut run bitwise equal to "
          f"the first; {RESUME_EPOCHS} epochs ({steps} train steps) {uncut_s:.3f} s and "
          f"{again_s:.3f} s with cuDNN's deterministic algorithms, {default_s:.3f} s with "
          f"its default algorithms, which moved the losses by max|d| {loss_d:.3e} and the "
          f"parameters by {param_d:.3e}")


def sweep_resume_phase(data: Path, root: Path) -> None:
    """12a. On phase 7's data, the 15-lane float32 sweep at full width for
    RESUME_EPOCHS epochs: uncut; then with trainer.checkpoint_every=1 and
    abort_after_epoch=RESUME_CUT (SweepAborted, a bundle a epoch); then
    resumed from the bundle (the main path, counted: exactly the remaining
    epochs' 3 gru_fwd_fb + 3 gru_bwd_fb a train step and 3 gru_fwd_fb an
    eval batch). Resumed against uncut under TRAIN_TOL; the bundle's write
    and read times."""
    argv = ["--set", f"trainer.epochs={RESUME_EPOCHS}", "--set", f"data_path={data}"]
    cfg = cli.load_config(cli.build_parser().parse_args(argv))
    corpus = pack_corpus(data, list(cfg.subjects), list(cfg.channels_to_use),
                         read_channel_names(data))
    fb = build_fold_batch(corpus, list(cfg.subjects), cfg.val_fraction, cfg.seed)
    t0 = time.perf_counter()
    uncut = fold_sweep.run_fold_sweep(corpus, fb, cfg, "cuda")
    uncut_s = time.perf_counter() - t0
    steps_tr = grid_steps(fb.n_train, cfg.trainer.batch_size)
    repeat_vs_uncut(corpus, fb, cfg, uncut, uncut_s, RESUME_EPOCHS * steps_tr)
    ck = dataclasses.replace(cfg, trainer=dataclasses.replace(
        cfg.trainer, checkpoint_every=1, resume=True))
    run_dir = root / "sweep_resume"
    run_dir.mkdir()
    with timed_calls(fold_sweep, "_save_sweep_resume") as writes:
        try:
            fold_sweep.run_fold_sweep(corpus, fb, ck, "cuda", run_dir=run_dir,
                                      abort_after_epoch=RESUME_CUT)
        except fold_sweep.SweepAborted as exc:
            aborted = str(exc)
        else:
            raise AssertionError("sweep resume: the drill did not raise SweepAborted")
        meta = json.loads((run_dir / "sweep_resume_meta.json").read_text())
        if meta != {"next_epoch": RESUME_CUT}:
            raise AssertionError(f"sweep resume: bundle meta {meta}")
        bundle_mib = (run_dir / "sweep_resume.msgpack").stat().st_size / 2**20
        with timed_calls(fold_sweep, "_load_sweep_resume") as reads:
            gru_cuda.reset_launch_counts()
            t0 = time.perf_counter()
            # --- the main path: everything between reset and read is counted ---
            resumed = fold_sweep.run_fold_sweep(corpus, fb, ck, "cuda", run_dir=run_dir)
            launches = gru_cuda.launch_counts()
            # --------------------------------------------------------------------
            resumed_s = time.perf_counter() - t0
    rest = dataclasses.replace(cfg.trainer, epochs=RESUME_EPOCHS - RESUME_CUT)
    expected, train_steps, eval_batches = sweep_expected_launches(fb, rest)
    if launches != expected or len(reads) != 1:
        raise AssertionError(f"sweep resume: launches {launches}, expected {expected} "
                             f"({train_steps} train steps, {eval_batches} eval batches); "
                             f"{len(reads)} bundle reads")
    for name in ("test_cm", "best_epoch", "stop_epoch"):
        if not np.isfinite(getattr(resumed, name)).all():
            raise AssertionError(f"sweep resume: {name} not finite")
    resumed_vs_uncut(_history_losses(resumed), _history_losses(uncut),
                     resumed.final_variables["params"],
                     uncut.final_variables["params"], TRAIN_TOL["float32"],
                     RESUME_EPOCHS * steps_tr, cfg.trainer.learning_rate,
                     f"sweep resume float32 F={len(fb.test_subjects)}")
    cm_moved = int(np.abs(resumed.test_cm - uncut.test_cm).sum())
    print(f"sweep resume float32: {aborted}; resumed from epoch {RESUME_CUT} of "
          f"{RESUME_EPOCHS}: {train_steps} train steps and {eval_batches} eval batches in "
          f"{resumed_s:.2f} s (uncut {RESUME_EPOCHS} epochs {uncut_s:.2f} s); test "
          f"confusion-matrix windows moved {cm_moved}; bundle {bundle_mib:.2f} MiB, write "
          f"(device to host, msgpack, logs, generators) median "
          f"{statistics.median(writes) * 1e3:.1f} ms of {len(writes)}, read "
          f"{reads[0] * 1e3:.1f} ms; launches {launches}")


def serial_resume_phase(data: Path, root: Path) -> None:
    """12b. On phase 6's data (fold 0 of LOSO_SUBJECTS), the serial
    Trainer (the default model, auto, float32, dropout 0.5) for
    RESUME_EPOCHS epochs: uncut; cut after RESUME_CUT (checkpoint_every=1);
    resumed in a new Trainer (the main path, counted: one launch of each of
    gru_fwd_fb, gru_fwd, gru_bwd_fb, gru_bwd a train step of the remaining
    epochs, of each forward an eval batch). Resumed against uncut under
    TRAIN_TOL; the bundle's write and read times."""
    cfg = cli.load_config(cli.build_parser().parse_args(
        ["--set", f"data_path={data}", "--set", "subjects=" + ",".join(LOSO_SUBJECTS)]))
    fold = loso_folds(cfg.subjects, cfg.val_fraction, cfg.seed)[0]
    names = read_channel_names(data)
    train, val = (build_dataset(data, list(sids), list(cfg.channels_to_use), names,
                                cfg.classification_mode, cfg.normalization)
                  for sids in (fold.train_subjects, fold.val_subjects))
    variables = random_variables(cfg, seed=0)

    def trainer(name: str, **fields):
        tcfg = dataclasses.replace(cfg.trainer, **{"epochs": RESUME_EPOCHS, **fields})
        return Trainer(build_model(cfg.model, 2, len(cfg.channels_to_use)), root / name,
                       tcfg, 2, device="cuda", variables=variables)

    uncut = trainer("uncut")
    uncut.train(train, val)
    with timed_calls(Trainer, "_save_resume") as writes:
        trainer("cut", checkpoint_every=1, epochs=RESUME_CUT).train(train, val)
        resumed = trainer("cut", checkpoint_every=1, resume=True)
        with timed_calls(Trainer, "_load_resume") as reads:
            gru_cuda.reset_launch_counts()
            # --- the main path: everything between reset and read is counted ---
            resumed.train(train, val)
            launches = gru_cuda.launch_counts()
            # --------------------------------------------------------------------
    bs = cfg.trainer.batch_size
    epochs = RESUME_EPOCHS - RESUME_CUT
    train_steps, eval_batches = epochs * -(-len(train) // bs), epochs * -(-len(val) // bs)
    expected = {"gru_fwd": train_steps + eval_batches, "gru_fwd_fb": train_steps + eval_batches,
                "gru_bwd": train_steps, "gru_bwd_fb": train_steps, "gru_bifwd": 0,
                "gru_bibwd": 0}
    if launches != expected or len(reads) != 1:
        raise AssertionError(f"serial resume: launches {launches}, expected {expected}; "
                             f"{len(reads)} bundle reads")
    if [e.epoch for e in resumed.history] != list(range(RESUME_CUT + 1, RESUME_EPOCHS + 1)):
        raise AssertionError(f"serial resume: epochs {[e.epoch for e in resumed.history]}")
    log = (root / "cut" / "training_log.txt").read_text()
    if f"Epoch {RESUME_CUT}/{RESUME_CUT}" not in log or "Resumed from epoch" not in log:
        raise AssertionError("serial resume: the log lost the epochs before the cut")
    losses = lambda hist: [v for e in hist for v in (e.train_loss, e.val_loss)]  # noqa: E731
    resumed_vs_uncut(losses(resumed.history), losses(uncut.history[RESUME_CUT:]),
                     export_jax_variables(resumed.model)["params"],
                     export_jax_variables(uncut.model)["params"], TRAIN_TOL["float32"],
                     RESUME_EPOCHS * -(-len(train) // bs), cfg.trainer.learning_rate,
                     "serial resume float32 dropout 0.5")
    print(f"serial resume float32: fold test={fold.test_subject}, {len(train)} train and "
          f"{len(val)} val windows, resumed from epoch {RESUME_CUT} of {RESUME_EPOCHS}: "
          f"{train_steps} train steps, {eval_batches} eval batches; bundle "
          f"{(root / 'cut' / 'resume_state.msgpack').stat().st_size / 2**20:.2f} MiB, write "
          f"median {statistics.median(writes) * 1e3:.1f} ms of {len(writes)}, read "
          f"{reads[0] * 1e3:.1f} ms; launches {launches}")


def profile_dir_phase(data: Path, root: Path) -> None:
    """12c. `main --profile-dir D --set trainer.epochs=1` on phase 7's data
    (counted as one sweep epoch): the Chrome trace in D exists, and names
    gru_fwd_fb and gru_bwd_fb (the launches' ranges) beside the walk
    kernels."""
    trace_dir = root / "trace"
    argv = ["--output-dir", str(root / "profile"), "--profile-dir", str(trace_dir),
            "--set", "trainer.epochs=1", "--set", f"data_path={data}"]
    cfg = cli.load_config(cli.build_parser().parse_args(argv))
    gru_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    # --- the main path: everything between reset and read is counted ---
    cli.main(argv)
    launches = gru_cuda.launch_counts()
    # --------------------------------------------------------------------
    wall = time.perf_counter() - t0
    corpus_fb = build_fold_batch(
        pack_corpus(data, list(cfg.subjects), list(cfg.channels_to_use),
                    read_channel_names(data)), list(cfg.subjects), cfg.val_fraction, cfg.seed)
    expected, _, _ = sweep_expected_launches(corpus_fb, cfg.trainer)
    if launches != expected:
        raise AssertionError(f"profile-dir: launches {launches}, expected {expected}")
    path = trace_dir / "sweep_trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    named = collections.Counter(e.get("name") for e in events)
    kernels = collections.Counter(e["name"].split("<")[0] for e in events
                                  if e.get("cat") == "kernel")
    if (named["gru_fwd_fb"] < launches["gru_fwd_fb"] or named["gru_bwd_fb"] < launches["gru_bwd_fb"]
            or not any("gru_walk_kernel" in k for k in kernels)):
        raise AssertionError(f"profile-dir: the trace names gru_fwd_fb {named['gru_fwd_fb']} "
                             f"and gru_bwd_fb {named['gru_bwd_fb']} times; kernels "
                             f"{kernels.most_common(8)}")
    print(f"profile-dir: main --profile-dir, 1 epoch in {wall:.2f} s; {path.name} "
          f"{path.stat().st_size / 2**20:.1f} MiB, {len(events)} events, ranges gru_fwd_fb "
          f"{named['gru_fwd_fb']} and gru_bwd_fb {named['gru_bwd_fb']}, kernel launches "
          f"{sum(kernels.values())} (" + ", ".join(f"{k} {n}" for k, n in
                                                   kernels.most_common(4)) + ")")


def probe_phase(data: Path, runs: dict[str, Path], root: Path) -> None:
    """12d. The attention probe CLI on the card (the main path, counted:
    one gru_fwd_fb and one gru_fwd a padded chunk of 256 windows) over
    phase 7's run (C=3: the constant gate) and phase 10e's fusion4 run
    (C=4, r=4: a rank-1 gate), PROBE_KINDS x PROBE_RATES; then fold S2 of
    the fusion4 run against the probe on the CPU: the probabilities of its
    corrupted windows within PROB_ATOL, the gate statistics equal, the
    accuracies within a window."""
    out = root / "probe.json"
    argv = [a for name, run in runs.items() for a in ("--run", f"{name}={run}")]
    argv += ["--data", str(data), "--rates", *PROBE_RATES, "--kinds", *PROBE_KINDS,
             "--out", str(out)]
    gru_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    # --- the main path: everything between reset and read is counted ---
    attention_probe.main(argv)
    launches = gru_cuda.launch_counts()
    # --------------------------------------------------------------------
    wall = time.perf_counter() - t0
    chunks, folds = 0, {}
    for name, run in runs.items():
        cfg = config_from_dict(ExperimentConfig, json.loads((run / "config.json").read_text()))
        folds[name] = len(cfg.subjects)
        for sid in cfg.subjects:
            n = len(build_dataset(data, [sid], list(cfg.channels_to_use),
                                  read_channel_names(data), cfg.classification_mode,
                                  cfg.normalization))
            chunks += len(PROBE_RATES) * len(PROBE_KINDS) * -(-n // attention_probe._EVAL_CHUNK)
    expected = {"gru_fwd": chunks, "gru_fwd_fb": chunks, "gru_bwd": 0, "gru_bwd_fb": 0,
                "gru_bifwd": 0, "gru_bibwd": 0}
    if launches != expected:
        raise AssertionError(f"probe: launches {launches}, expected {expected}")
    results = json.loads(out.read_text())["results"]
    for name, agg in results.items():
        accs = [agg[k][r]["accuracy"] for k in PROBE_KINDS for r in PROBE_RATES]
        if agg["num_folds"] != folds[name] or not all(math.isfinite(a) for a in accs):
            raise AssertionError(f"probe: {name} gives {agg}")
    gate = results["fusion4_r4"]["rail"]["1"]
    const = results["attention_c3"]["rail"]["1"]
    if const["gate_corrupted"] != 0.5 or gate["gate_corrupted"] == gate["gate_other"]:
        raise AssertionError(f"probe: gates {const} (C=3), {gate} (C=4)")
    print(f"probe: attention_probe CLI on the card, {len(runs)} runs of "
          f"{'/'.join(map(str, folds.values()))} folds x {len(PROBE_KINDS)} kinds x "
          f"{len(PROBE_RATES)} rates in {wall:.2f} s; "
          + "; ".join(f"{name} accuracy @0/0.5/1 rail "
                      + "/".join(f"{agg['rail'][r]['accuracy']:.4f}" for r in PROBE_RATES)
                      + f", gate corrupted/other at rate 1 {agg['rail']['1']['gate_corrupted']:.4f}"
                      f"/{agg['rail']['1']['gate_other']:.4f}"
                      for name, agg in results.items()) + f"; launches {launches}")

    run = runs["fusion4_r4"]
    card_p = Predictor.from_run(run, "S2", device="cuda")
    cpu_p = Predictor.from_run(run, "S2", device="cpu")
    ds = build_dataset(data, ["S2"], list(card_p.cfg.channels_to_use), read_channel_names(data),
                       card_p.cfg.classification_mode, card_p.cfg.normalization)
    xc, _, _ = attention_probe.corrupt_windows(ds.x, 0.5, "rail", seed=1)
    err = _check_probs(attention_probe._batched_probs(card_p, xc),
                       attention_probe._batched_probs(cpu_p, xc), len(xc),
                       PROB_ATOL["float32"], "probe fold S2 card vs CPU")
    rates = [0.0, 0.5]
    card_r, cpu_r = (attention_probe.probe_fold(p, ds.x, ds.y, rates, ["rail"], seed=1,
                                                num_classes=2) for p in (card_p, cpu_p))
    for r in rates:
        a, b = card_r["rail"][f"{r:g}"], cpu_r["rail"][f"{r:g}"]
        if (abs(a["accuracy"] - b["accuracy"]) > 1 / len(ds.y) + 1e-12 or any(
                not (a[k] == b[k] or (math.isnan(a[k]) and math.isnan(b[k])))
                for k in ("gate_corrupted", "gate_other", "gate_clean_mean"))):
            raise AssertionError(f"probe fold S2 rate {r}: card {a}, CPU {b}")
    print(f"probe fold S2 (fusion4, rank-1 gate): {len(xc)} windows, max|probs card - CPU| "
          f"{err:.3e} (atol {PROB_ATOL['float32']}); probe_fold card vs CPU: accuracies "
          + ", ".join(f"{card_r['rail'][f'{r:g}']['accuracy']:.4f}/"
                      f"{cpu_r['rail'][f'{r:g}']['accuracy']:.4f}" for r in rates)
          + ", gate statistics equal")


def phase12(root: Path, data: Path, loso_data: Path, sweep_run: Path,
            fusion4_run: Path) -> None:
    """Phase 12 (module docstring): 12a the sweep's resume drill, 12b the
    serial Trainer's resume, 12c main --profile-dir, 12d the attention
    probe."""
    t_phase = time.perf_counter()
    root.mkdir()
    marks = [time.perf_counter()]
    sweep_resume_phase(data, root)
    marks.append(time.perf_counter())
    serial_resume_phase(loso_data, root)
    marks.append(time.perf_counter())
    profile_dir_phase(data, root)
    marks.append(time.perf_counter())
    probe_phase(data, {"attention_c3": sweep_run, "fusion4_r4": fusion4_run}, root)
    marks.append(time.perf_counter())
    split = ", ".join(f"12{k} {b - a:.1f} s" for k, a, b in zip("abcd", marks, marks[1:]))
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s ({split})")


# Phase 13: the fused pair under the fold axis and the pack cache. The fused
# pair's lane counts beyond one layer's two: a sweep's 15 folds (30 lanes), 4 seed
# groups of them (120), and a ragged shape (3 folds at T=37, B=5, H=40).
FUSED_LANE_CASES = [(30, SERVE_T, SERVE_B, SERVE_H), (2 * SEED_LANES, SERVE_T, SERVE_B, SERVE_H),
                    (6, 37, 5, 40)]


def fused_lanes_phase() -> None:
    """13a. gru_bifwd and gru_bibwd at L = 2F lanes (FUSED_LANE_CASES)
    against their plain versions: ys at TOL, the adjoint's outputs at
    BWD_TOL, dW and db bitwise over two runs; at T=480, B=64, H=64 the
    times beside the bound at L lanes, the row tile, blocks and waves, and
    two baselines: auto's two F-lane walks (gru_fwd_fb / gru_bwd_fb, both
    directions) and cuDNN's bidirectional nn.GRU called F times."""
    f32 = torch.float32
    for lanes, t, b, h in FUSED_LANE_CASES:
        folds = lanes // 2
        for adjoint, name, wrapper, plain in (
                (False, "gru_bifwd", gru_cuda.gru_bifwd, gru_cuda.gru_bifwd_plain),
                (True, "gru_bibwd", gru_cuda.gru_bibwd, gru_cuda.gru_bibwd_plain)):
            args = fused_inputs(t, b, h, seed=lanes + t, adjoint=adjoint, lanes=lanes)
            got = wrapper(*args)
            torch.cuda.synchronize()
            want = plain(*args)
            outputs = ("dxg2", "dW", "db", "dh0") if adjoint else ("ys2",)
            got, want = (got, want) if adjoint else ((got,), (want,))
            errs = []
            for o, g, w in zip(outputs, got, want):
                if g.dtype != f32 or g.shape != w.shape:
                    raise AssertionError(f"{name} L={lanes} {o}: got {g.dtype} {list(g.shape)}")
                tol = BWD_TOL[f32][o in ("dW", "db")] if adjoint else TOL[f32]
                torch.testing.assert_close(g, w, **tol,
                                           msg=lambda m, o=o: f"{name} L={lanes} {o}: {m}")
                errs.append((g - w).abs().max().item())
            del got, want
            plan = adj_plan(lanes, t, b, h) if adjoint else walk_plan(lanes, b, h)
            print(f"{name}: L={lanes} ({folds} folds) T={t} B={b} H={h} float32: max|d| "
                  + ", ".join(f"{o} {e:.3e}" for o, e in zip(outputs, errs)) + f" ({plan})")
            if adjoint:
                check_deterministic(name, wrapper, args, f"L={lanes} float32")
            if (t, b, h) == (SERVE_T, SERVE_B, SERVE_H):
                ms = median_ms(lambda: wrapper(*args), per_block=10)
                del args
                b_ms, b_by = (bwd_bound_ms if adjoint else bound_ms)(lanes, t, b, h, f32)
                if adjoint:
                    fb = bwd_inputs(folds, t, b, h, f32, seed=lanes)
                    two = lambda: (gru_cuda.gru_backward_fb(*fb),  # noqa: E731
                                   gru_cuda.gru_backward_fb(*fb, reverse=True))
                else:
                    fb = kernel_inputs(folds, t, b, h, f32, seed=lanes)
                    two = lambda: (gru_cuda.gru_forward_fb(*fb),  # noqa: E731
                                   gru_cuda.gru_forward_fb(*fb, reverse=True))
                two_ms = median_ms(two, per_block=10)
                del fb
                lib_ms = (cudnn_bwd_ms if adjoint else cudnn_ms)(2, t, b, h, f32, calls=folds)
                print(f"{name} float32 at L={lanes} ({folds} folds x 2 directions) T={t} "
                      f"B={b} H={h}: kernel {ms:.4f} ms ({ms / t * 1e3:.3f} us per dependent "
                      f"step, {plan}, {waves(adjoint, b, lanes, h, f32)}), bound "
                      f"{b_ms:.5f} ms ({b_by}), {b_ms / ms:.2%} of bound; auto's two "
                      f"gru_{'bwd' if adjoint else 'fwd'}_fb at F={folds} {two_ms:.4f} ms; "
                      f"cuDNN bidirectional GRU {'backward ' if adjoint else ''}x{folds} "
                      f"{lib_ms:.4f} ms")
            else:
                del args
            torch.cuda.empty_cache()


def pack_cache_phase(data: Path, root: Path) -> None:
    """13e. The sweep CLI (1 epoch) twice on a fresh copy of phase 7's data
    directory: the first run misses and writes one entry under
    .pack_cache, the second reads it back (a read-only memory map), and
    the hit's corpus equals the miss's bitwise; each run's staging seconds
    (stage_corpus, host clock). Then a run with MMS_PACK_CACHE=0 on another
    copy writes nothing."""
    fresh, off = root / "cache_data", root / "cache_off_data"
    for d in (fresh, off):
        shutil.copytree(data, d, ignore=shutil.ignore_patterns(".pack_cache"))
    staged = []
    real = fold_sweep.stage_corpus

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        corpus = real(*args, **kwargs)
        staged.append((time.perf_counter() - t0, corpus))
        return corpus

    def run(data_dir: Path, name: str) -> None:
        cli.main(["--output-dir", str(root / name), "--set", "trainer.epochs=1",
                  "--set", f"data_path={data_dir}"])

    fold_sweep.stage_corpus = timed
    saved = os.environ.get("MMS_PACK_CACHE")
    try:
        run(fresh, "cache_miss")
        entries = list((fresh / ".pack_cache").iterdir())
        run(fresh, "cache_hit")
        os.environ["MMS_PACK_CACHE"] = "0"
        run(off, "cache_off")
    finally:
        fold_sweep.stage_corpus = real
        if saved is None:
            os.environ.pop("MMS_PACK_CACHE", None)
        else:
            os.environ["MMS_PACK_CACHE"] = saved
    (miss_s, miss), (hit_s, hit), (off_s, _) = staged
    if len(entries) != 1 or list((fresh / ".pack_cache").iterdir()) != entries:
        raise AssertionError(f"pack cache: entries after the miss {entries}")
    if isinstance(miss.x, np.memmap) or not isinstance(hit.x, np.memmap):
        raise AssertionError("pack cache: the second run did not read the entry back")
    if hit.subjects != miss.subjects or not all(
            np.array_equal(np.asarray(getattr(hit, k)), getattr(miss, k))
            and np.asarray(getattr(hit, k)).dtype == getattr(miss, k).dtype
            for k in ("x", "y", "mask")):
        raise AssertionError("pack cache: the hit's corpus differs from the miss's")
    if (off / ".pack_cache").exists():
        raise AssertionError("pack cache: a MMS_PACK_CACHE=0 run wrote an entry")
    size = sum(f.stat().st_size for f in entries[0].iterdir())
    print(f"pack cache: {len(miss.subjects)} subjects, x {list(miss.x.shape)} "
          f"({size / 2**20:.1f} MiB on disk); staging {miss_s:.3f} s on the miss (entry "
          f"written), {hit_s:.3f} s on the hit (memory map), bitwise equal; "
          f"MMS_PACK_CACHE=0 staged in {off_s:.3f} s and wrote nothing")


def phase13(root: Path, data: Path, loso_run: Path, wesad: Path) -> dict[str, int]:
    """Phase 13 (module docstring): 13a the fused pair at 2F lanes, 13b the
    fused sweep (f32, bf16), 13c the ensembles of phase 6's serial
    pallas_fused run and of 13b's f32 run, 13d the hierarchical run with a
    fused M1 and --seeds 42 43 fused, 13e the pack cache. Returns 13b's
    float32 launches (the fused sweep: the main path of this phase)."""
    t_phase = time.perf_counter()
    root.mkdir()
    marks = [time.perf_counter()]
    fused_lanes_phase()
    marks.append(time.perf_counter())
    with capture_sweeps(fold_sweep) as seen:
        launches, fused_run = sweep_phase("float32", ["--set", f"data_path={data}"], root,
                                          "fused_sweep", db_step=False, impl="pallas_fused")
    sweep_phase("bfloat16", ["--set", f"data_path={data}"], root, "fused_sweep",
                db_step=False, impl="pallas_fused")
    marks.append(time.perf_counter())
    ensemble_phase(loso_run, "serial pallas_fused ensemble")
    ensemble_phase(fused_run, "fused sweep ensemble", serve=False)
    marks.append(time.perf_counter())
    hier_sharded_phase(wesad, root, m1_impl="pallas_fused", stages=False)
    replicated_phase(data, root, seen[0], seeds=SEEDS[:2], impl="pallas_fused", profile=False)
    marks.append(time.perf_counter())
    pack_cache_phase(data, root)
    marks.append(time.perf_counter())
    split = ", ".join(f"13{k} {b - a:.1f} s" for k, a, b in zip("abcde", marks, marks[1:]))
    print(f"phase 13: {time.perf_counter() - t_phase:.1f} s ({split})")
    return launches

# Phase 14: the sweep split over two processes (parallel/multihost.py), both
# ranks on the one card, their collectives on gloo over host tensors. Each
# rank is `python chip_smoke.py jobs JOBS.json` (rank_worker)
# and reports on a line that starts with RANK_LINE.
RANK_LINE = "phase14 rank "
RANK_DEADLINE_S = 300


@contextlib.contextmanager
def drilled():
    """The plain sweep under the preemption drill: SweepAborted after
    epoch 1."""
    real = fold_sweep.run_fold_sweep
    fold_sweep.run_fold_sweep = lambda *a, **k: real(*a, abort_after_epoch=1, **k)
    try:
        yield
    finally:
        fold_sweep.run_fold_sweep = real


def counted_main(argv: list[str], results: Path, drill: bool = False) -> dict:
    """The experiment CLI's main(argv) in this process (the main path,
    counted): its launches, wall seconds, the seconds of each of its
    run_fold_sweep calls and of each sweep epoch (FoldSweep.epoch) and the
    peak device memory; the SweepResults of its sweeps (every rank holds
    the whole sweep's) pickled to `results` by rank 0. With `drill`, under
    the preemption drill, whose SweepAborted must come."""
    rank = int(os.environ.get("MMS_PROCESS_ID", "0"))
    modules = (fold_sweep, replicated_sweep, hierarchical_sweep)
    with contextlib.ExitStack() as stack:
        if drill:
            stack.enter_context(drilled())
        seen = [stack.enter_context(capture_sweeps(m)) for m in modules]
        sweep_s = [stack.enter_context(timed_calls(m, "run_fold_sweep")) for m in modules]
        epoch_s = stack.enter_context(timed_calls(FoldSweep, "epoch"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gru_cuda.reset_launch_counts()
        t0 = time.perf_counter()
        # --- the main path: everything between reset and read is counted ---
        aborted = False
        try:
            cli.main(argv)
        except fold_sweep.SweepAborted:
            if not drill:
                raise
            aborted = True
        launches = gru_cuda.launch_counts()
        # --------------------------------------------------------------------
        wall = time.perf_counter() - t0
    if drill and not aborted:
        raise AssertionError(f"rank {rank}: the drill did not raise SweepAborted")
    if rank == 0:
        results.write_bytes(pickle.dumps([r for found in seen for r in found]))
    return {"rank": rank, "launches": launches, "wall_s": wall,
            "sweep_s": [t for found in sweep_s for t in found], "epoch_s": epoch_s,
            "peak_mib": torch.cuda.max_memory_allocated() / 2**20}


def rank_worker(jobs_file: str) -> int:
    """One rank of phase 14: runs each job of `jobs_file` (spawn_ranks'
    JSON list: run id, coordinator, results path, main's argv, drill) in
    turn, counted_main under that job's MMS_COORDINATOR and MMS_RUN_ID
    (main joins the job's process group and leaves it), each reported on a
    RANK_LINE line with its index. TF32 off, as in main()."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for i, job in enumerate(json.loads(Path(jobs_file).read_text())):
        os.environ["MMS_COORDINATOR"] = job["coordinator"]
        os.environ["MMS_RUN_ID"] = job["run_id"]
        line = counted_main(job["argv"], Path(job["results"]), drill=job["drill"])
        print(RANK_LINE + json.dumps({"job": i, **line}), flush=True)
    return 0


def free_ports(n: int) -> list[int]:
    """n distinct free ports on the loopback (all bound at once, then
    released)."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for sock in socks:
            sock.bind(("127.0.0.1", 0))
        return [sock.getsockname()[1] for sock in socks]
    finally:
        for sock in socks:
            sock.close()


def spawn_ranks(jobs: list[tuple[str, list[str], bool]], root: Path, name: str,
                world: int = 2) -> list[tuple[list[dict], Path]]:
    """`world` rank processes (rank r on cuda:{r % device_count}, main's
    rule) that run `jobs`, (run id, main's argv, drill) each, one after
    another, each job's ranks joined on a free port of its own; all must
    exit 0 within RANK_DEADLINE_S a job, or all are killed and the phase
    fails. Returns, for each job, (each rank's line in rank order, with
    "process_s": the host seconds from the spawn to the last exit; rank 0's
    pickled SweepResults)."""
    specs = [{"run_id": run_id, "argv": argv, "drill": drill,
              "coordinator": f"127.0.0.1:{port}",
              "results": str(root / f"{run_id}_{'drill' if drill else 'rank'}_results.pkl")}
             for (run_id, argv, drill), port in zip(jobs, free_ports(len(jobs)))]
    jobs_file = root / f"{name}_jobs.json"
    jobs_file.write_text(json.dumps(specs))
    logs = [root / f"{name}_rank{r}.log" for r in range(world)]
    procs = []
    deadline_s = RANK_DEADLINE_S * len(jobs)
    t0 = time.perf_counter()
    try:
        for rank, log in enumerate(logs):
            env = dict(os.environ, MMS_NUM_PROCESSES=str(world), MMS_PROCESS_ID=str(rank),
                       MMS_DIST_TIMEOUT=str(RANK_DEADLINE_S))
            with open(log, "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()), "jobs", str(jobs_file)],
                    cwd=Path(__file__).resolve().parent, env=env, stdout=out,
                    stderr=subprocess.STDOUT))
        deadline = time.monotonic() + deadline_s
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{name}: the ranks did not finish within {deadline_s} s:\n"
                             + "\n".join(log.read_text()[-4000:] for log in logs)) from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    process_s = time.perf_counter() - t0
    outs = [log.read_text() for log in logs]
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"{name}: rank {rank} exited {p.returncode}:\n"
                                 f"{out[-6000:]}")
    lines = [json.loads(line[len(RANK_LINE):]) for out in outs for line in out.splitlines()
             if line.startswith(RANK_LINE)]
    out = []
    for i, spec in enumerate(specs):
        got = [line for line in lines if line["job"] == i]
        if [line["rank"] for line in got] != list(range(world)):
            raise AssertionError(f"{name} job {spec['run_id']}: rank lines {got}")
        for line in got:
            line["process_s"] = process_s
        out.append((got, Path(spec["results"])))
    return out


def _run_files(run_dir: Path) -> list[str]:
    return sorted(str(p.relative_to(run_dir)) for p in run_dir.rglob("*") if p.is_file())


def split_vs_one(got: list, want: list, cfg_steps: list[tuple[int, float]], tol: dict,
                 what: str, cm_windows: int | None = None, world: int = 2) -> None:
    """Each SweepResult of the split run against the one-process run's
    (resumed_vs_uncut's TRAIN_TOL check of the losses and parameters; each
    with its (Adam steps, lr)); with `cm_windows`, every lane's test
    confusion matrix within that many windows."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} sweeps against {len(want)}")
    for i, (g, w, (steps, lr)) in enumerate(zip(got, want, cfg_steps)):
        resumed_vs_uncut(_history_losses(g), _history_losses(w), g.final_variables["params"],
                         w.final_variables["params"], tol, steps, lr,
                         f"{what} sweep {i + 1}/{len(want)}", f"{world} ranks vs 1 process")
        moved = np.abs(g.test_cm - w.test_cm).sum(axis=(1, 2))
        if cm_windows is not None and moved.max() > cm_windows:
            raise AssertionError(f"{what}: test confusion matrices moved {moved} windows")
        print(f"{what} sweep {i + 1}: test confusion-matrix windows moved {int(moved.sum())}"
              + ("" if cm_windows is None else f" (at most {cm_windows} a lane)"))


# One run of split_runs: (name, main's argv, the launches expected of the one
# process and of each rank, each sweep's (Adam steps, lr), tol, cm_windows).
SplitRun = tuple[str, list[str], dict[str, int], list[tuple[int, float]], dict, int | None]


def split_runs(root: Path, name: str, runs: list[SplitRun], world: int = 2,
               tail: tuple = ()) -> tuple[list[tuple[list[dict], Path, Path, list]], list]:
    """Each run's `main argv` in this process, then all of them as jobs of
    one set of `world` rank processes (spawn_ranks), then `tail`'s jobs
    there ((run id, argv, drill) each); for each run: the launches of the
    one process and of each rank exactly `expected` (a rank runs the whole
    sweep's steps over its own lanes), the same run-directory file list,
    split_vs_one; each rank's wall time, sweep and epoch seconds and peak
    memory beside the one process's. Returns (for each run: the ranks'
    lines, the one-process and split run directories, the split run's
    SweepResults), and the tail jobs' (lines, results)."""
    ones = [counted_main([*argv, "--output-dir", str(root / f"{what}_one")],
                         root / f"{what}_one.pkl") for what, argv, *_ in runs]
    spawned = spawn_ranks([(what, [*argv, "--output-dir", str(root / f"{what}_split")], False)
                           for what, argv, *_ in runs] + list(tail), root, name, world)
    out = []
    for (what, _, expected, cfg_steps, tol, cm_windows), one, (lines, results) in zip(
            runs, ones, spawned):
        for line in [one, *lines]:
            if line["launches"] != expected:
                raise AssertionError(f"{what}: rank {line['rank']} of "
                                     f"{world if line is not one else 1} launched "
                                     f"{line['launches']}, expected {expected}")
        (one_run,) = (p for p in (root / f"{what}_one").rglob("run_*") if p.is_dir())
        (two_run,) = (p for p in (root / f"{what}_split").rglob("run_*") if p.is_dir())
        if _run_files(one_run) != _run_files(two_run):
            raise AssertionError(f"{what}: run directories differ: {_run_files(one_run)} "
                                 f"against {_run_files(two_run)}")
        got = pickle.loads(results.read_bytes())
        split_vs_one(got, pickle.loads((root / f"{what}_one.pkl").read_bytes()), cfg_steps,
                     tol, what, cm_windows, world)
        timing = lambda d: (f"wall {d['wall_s']:.2f} s, sweeps "  # noqa: E731
                            + "+".join(f"{t:.2f}" for t in d["sweep_s"]) + " s, epochs "
                            + "/".join(f"{t:.3f}" for t in d["epoch_s"])
                            + f" s, peak {d['peak_mib']:.1f} MiB")
        print(f"{what}: 1 process {timing(one)}; "
              + "; ".join(f"rank {d['rank']}/{world} {timing(d)}" for d in lines)
              + f"; {len(_run_files(two_run))} run-directory files as in one process; "
              f"launches a rank {expected}")
        out.append((lines, one_run, two_run, got))
    print(f"{name}: the {world} rank processes ran {len(spawned)} jobs in turn, "
          f"{spawned[0][0][0]['process_s']:.2f} s from spawn to exit")
    return out, spawned[len(runs):]


def dropout_rng_cost(corpus, fb, cfg) -> None:
    """14a. ms per sweep train step at the config's dropout (the median
    of 3 blocks of 5 steps): all 15 lanes in one process, rank 0's 8 lanes
    drawing the whole sweep's masks (its split run's step), and those 8
    lanes with dropout 0 (no masks)."""
    folds = fb.train_pool.shape[0]
    init, rngs = seed_group_streams((cfg.seed,), folds)
    block = fold_sweep.rank_block(folds, 0, 2)
    cases = [("15 lanes", cfg, None), (f"rank 0's {block[1]} lanes", cfg, block),
             (f"rank 0's {block[1]} lanes, dropout 0",
              dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dropout=0.0)),
              block)]
    out = []
    for name, c, b in cases:
        sweep = FoldSweep(corpus, fb, c, "cuda", init_seeds=init, block=b)
        idx, w = sweep.to_device(sweep.train_grid(rngs))
        ms = median_ms(lambda: sweep.train_step(idx[:, 0], w[:, 0]), 5, blocks=3)
        out.append(f"{name} {ms:.3f} ms")
        del sweep, idx, w
    torch.cuda.empty_cache()
    print(f"sweep split dropout {cfg.model.dropout}: train step " + ", ".join(out)
          + " (one process, one rank alone on the card)")


def split_scaling(world: int = 4) -> None:
    """Not run by main(): the sweep split over `world` processes, one a card
    (rank r on cuda:r), against one process on cuda:0, on phase 7's data at
    full width, f32 auto: the plain sweep (15 folds, 4 epochs) and --seeds
    42 43 44 45 (60 lanes, 2 epochs), each through split_run (exact
    launches a rank, TRAIN_TOL; the seeds' confusion matrices within
    SEED_GROUP_TOL), with every rank's sweep and epoch seconds and peak
    memory beside the one process's. Needs `world` cards:

        python -c "import chip_smoke as cs; cs.split_scaling(4)"
    """
    if torch.cuda.device_count() < world:
        raise RuntimeError(f"split_scaling({world}) needs {world} cards, "
                           f"this machine has {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card()
    _build.build()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "scaling"
        root.mkdir()
        data = write_loso_data(Path(tmp) / "sweep_data", seed=8, subjects=ALL_SUBJECTS)
        base = ["--set", f"data_path={data}"]
        cfg = cli.load_config(cli.build_parser().parse_args(base))
        corpus = pack_corpus(data, list(cfg.subjects), list(cfg.channels_to_use),
                             read_channel_names(data))
        fb = build_fold_batch(corpus, list(cfg.subjects), cfg.val_fraction, cfg.seed)
        steps_tr = grid_steps(fb.n_train, cfg.trainer.batch_size)
        lr = cfg.trainer.learning_rate
        runs = []
        for what, argv, epochs, cm in (("scale_sweep", [], 4, None),
                                       ("scale_seeds", ["--seeds", *map(str, SEEDS)], 2,
                                        SEED_GROUP_TOL["cm_windows"])):
            tcfg = dataclasses.replace(cfg.trainer, epochs=epochs)
            runs.append((what, [*base, "--set", f"trainer.epochs={epochs}", *argv],
                         sweep_expected_launches(fb, tcfg)[0], [(epochs * steps_tr, lr)],
                         TRAIN_TOL["float32"], cm))
        t0 = time.perf_counter()
        split_runs(root, "scale", runs, world)
        print(f"scale: {time.perf_counter() - t0:.1f} s, {world} ranks on cuda:0-"
              f"{world - 1} against one process on cuda:0")


def phase14(root: Path, data: Path) -> dict[str, int]:
    """Phase 14 (module docstring): the sweep split over two processes on
    the one card. 14a auto, 14b pallas_fused, 14c --seeds and
    --hierarchical, 14d a two-rank run cut and resumed by two ranks.
    Returns the launches of 14a's and 14b's two-rank runs (both ranks):
    the main path of this phase."""
    t_phase = time.perf_counter()
    root.mkdir()
    marks = [time.perf_counter()]
    base = ["--set", f"data_path={data}", "--set", "trainer.epochs=2"]
    cfg = cli.load_config(cli.build_parser().parse_args(base))
    corpus = pack_corpus(data, list(cfg.subjects), list(cfg.channels_to_use),
                         read_channel_names(data))
    fb = build_fold_batch(corpus, list(cfg.subjects), cfg.val_fraction, cfg.seed)
    steps_tr = grid_steps(fb.n_train, cfg.trainer.batch_size)
    lr = cfg.trainer.learning_rate
    tol = TRAIN_TOL["float32"]
    total = dict.fromkeys(KERNELS, 0)

    def add(lines):
        for line in lines:
            for k in KERNELS:
                total[k] += line["launches"][k]

    # a. auto, 2 epochs; b. pallas_fused, 1 epoch; c. --seeds 42 43 and
    # --hierarchical, 1 epoch; then d's cut: all as jobs of one pair of ranks.
    fused = [*base, "--set", "trainer.epochs=1", "--set", "model.gru_impl=pallas_fused"]
    fcfg = cli.load_config(cli.build_parser().parse_args(fused))
    seeds = [*base, "--set", "trainer.epochs=1", "--seeds", "42", "43"]
    scfg = cli.load_config(cli.build_parser().parse_args(seeds))
    hier = ["--hierarchical", "--set", f"base.data_path={data}", "--set", "base.trainer.epochs=1"]
    hcfg = cli.load_config(cli.build_parser().parse_args(hier))
    union, _, _ = union_channel_indices(hcfg.m1_channels, hcfg.m2_channels)
    names = read_channel_names(data)
    b = hcfg.base
    fb1, fb2, fb_u = (build_fold_batch(pack_corpus(data, list(b.subjects), list(ch), names, mode),
                                       list(b.subjects), b.val_fraction, b.seed)
                      for ch, mode in ((hcfg.m1_channels, "stress_binary"),
                                       (hcfg.m2_channels, "amusement_binary"),
                                       (union, "ternary")))
    ck = [*base, "--set", "trainer.checkpoint_every=1", "--set", "trainer.resume=true",
          "--output-dir", str(root / "split_cut")]
    runs = [("split_auto", base, sweep_expected_launches(fb, cfg.trainer)[0],
             [(2 * steps_tr, lr)], tol, None),
            ("split_fused", fused, sweep_expected_launches(fb, fcfg.trainer, fcfg.model)[0],
             [(steps_tr, lr)], tol, None),
            ("split_seeds", seeds, sweep_expected_launches(fb, scfg.trainer)[0],
             [(steps_tr, lr)], tol, SEED_GROUP_TOL["cm_windows"]),
            ("split_hier", hier, hier_expected_launches(hcfg, fb1, fb2, fb_u),
             [(grid_steps(f.n_train, b.trainer.batch_size), b.trainer.learning_rate)
              for f in (fb1, fb2)], tol, None)]
    done, _ = split_runs(root, "split", runs, tail=[("split_cut", ck, True)])
    add(done[0][0])
    add(done[1][0])
    (cut_run,) = (root / "split_cut").rglob("run_split_cut")
    meta = json.loads((cut_run / "sweep_resume_meta.json").read_text())
    if meta != {"next_epoch": 1} or list(cut_run.glob("fold_test_on_*")):
        raise AssertionError(f"split cut: bundle meta {meta}, {_run_files(cut_run)}")
    marks.append(time.perf_counter())

    # a's two-rank run directory served; dropout's cost.
    _, one_run, two_run, uncut = done[0]
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((64, 3, WINDOW_T))
                         .astype(np.float32)).cuda()
    ens = EnsemblePredictor.from_run(two_run, device="cuda")
    gru_cuda.reset_launch_counts()
    # --- the main path: everything between reset and read is counted ---
    with torch.inference_mode():
        probs = ens.predict_tensor(x)
    ens_launches = gru_cuda.launch_counts()
    # --------------------------------------------------------------------
    if ens_launches != fold_walks()[0]:
        raise AssertionError(f"split ensemble: launches {ens_launches}")
    with torch.inference_mode():
        want = EnsemblePredictor.from_run(one_run, device="cuda").predict_tensor(x)
    err = _check_probs(probs.cpu().numpy(), want.cpu().numpy(), 64, PROB_ATOL["float32"],
                       "split ensemble vs the one-process run's")
    print(f"split ensemble: the two-rank run directory served by EnsemblePredictor "
          f"({len(ens.fold_names)} folds, one padded-64 forward, launches {ens_launches}); "
          f"max|probs - the one-process run's| = {err:.3e} (atol {PROB_ATOL['float32']})")
    del ens
    dropout_rng_cost(corpus, fb, cfg)
    marks.append(time.perf_counter())

    # d. The cut run resumed by two new rank processes.
    ((lines, results),) = spawn_ranks([("split_cut", ck, False)], root, "split_resume")
    rest = sweep_expected_launches(fb, dataclasses.replace(cfg.trainer, epochs=1))[0]
    if any(line["launches"] != rest for line in lines):
        raise AssertionError(f"split resume: launches {[d['launches'] for d in lines]}, "
                             f"expected {rest} a rank (the remaining epoch)")
    (resumed,) = pickle.loads(results.read_bytes())
    resumed_vs_uncut(_history_losses(resumed), _history_losses(uncut[0]),
                     resumed.final_variables["params"], uncut[0].final_variables["params"],
                     tol, 2 * steps_tr, lr, "split resume float32 F=15")
    print(f"split resume: 2 ranks cut after epoch 1 of 2 and resumed by 2 ranks; each rank "
          f"launched exactly the remaining epoch's {rest}; wall "
          + ", ".join(f"rank {d['rank']} {d['wall_s']:.2f} s" for d in lines))
    marks.append(time.perf_counter())
    split = ", ".join(f"{k} {b - a:.1f} s" for k, a, b in zip(
        ("14a-c and 14d's cut", "14a's ensemble and dropout cost", "14d's resume"),
        marks, marks[1:]))
    print(f"phase 14: {time.perf_counter() - t_phase:.1f} s ({split})")
    return total


# Phase 15: the walks past one block's shared memory (the cluster walk: W
# split over a thread block cluster of K <= 8 CTAs, h' or dg exchanged over
# distributed shared memory) and fold grouping (MMS_GRU_FOLD_GROUP) on them.
BIG_H = 256
LARGE_HS = (137, 180, 192, BIG_H)   # and each entry's limit in each dtype
ADJOINTS = ("gru_bwd", "gru_bwd_fb", "gru_bibwd")
WRAPPERS = {"gru_fwd": (gru_cuda.gru_forward, gru_cuda.gru_forward_plain),
            "gru_fwd_fb": (gru_cuda.gru_forward_fb, gru_cuda.gru_forward_fb_plain),
            "gru_bifwd": (gru_cuda.gru_bifwd, gru_cuda.gru_bifwd_plain),
            "gru_bwd": (gru_cuda.gru_backward, gru_cuda.gru_backward_plain),
            "gru_bwd_fb": (gru_cuda.gru_backward_fb, gru_cuda.gru_backward_fb_plain),
            "gru_bibwd": (gru_cuda.gru_bibwd, gru_cuda.gru_bibwd_plain)}
FOLD_GROUP = 3   # 15 folds as 5 lanes of G*H = 192
# 15a's further adjoint shapes: a batch no row tile of 2 or 4 divides (at
# BIG_H), the one-block walk with W in shared memory at a row tile past 1
# (gru_bwd_fb at the sweep's 15 lanes, H=100) and the sweep's lanes at
# BIG_H.
ROW_TILE_B = 37
TILED_ONE_BLOCK_H = 100
SWEEP_F = 15
# The adjoints timed at the parent commit and here (adjoint_ab), by dtype:
# one block (100), the cluster walk, and where the plan weighs the cluster
# walk against the grid walk (300-512).
AB_HS = {torch.float32: (100, 137, 192, BIG_H, 300, 340, 376),
         torch.bfloat16: (100, 137, 192, BIG_H, 340, 400, 450, 512)}
# 15b: the adjoint walk's candidates (adj_candidates: every tile of the
# one-block and cluster walks that fits, and the grid walk) timed alone at
# T=480 and these H and (B, lanes), the figures csrc/gru_bwd.cu's model of
# a step is fitted to; the plan's choice is to be the fastest or within
# CHOICE_SLACK of it. Each candidate is first held against the plain version
# at T=CANDIDATE_CHECK_T.
CANDIDATE_HS = {torch.float32: (BIG_H, 300, 340, 376), torch.bfloat16: (BIG_H, 340, 400, 450, 512)}
CANDIDATE_SHAPES = ((SERVE_B, 1), (SERVE_B, 2), (SERVE_B, SWEEP_F), (ROW_TILE_B, 2))
CHOICE_SLACK = 1.05
CANDIDATE_CHECK_T = 16
# 15a's steps at the shapes whose choice moved from the parent commit's
# (24 of the walk's producer chunks with W in shared memory).
MOVED_T = 96
# 15b's split of a cluster-walk step (adjoint_step_split), by dtype: (H,
# lanes, K, R), timed in a copy of gru_bwd.cu with clock64() stamps.
STEP_SPLITS = {torch.float32: (BIG_H, SWEEP_F, 5, 4), torch.bfloat16: (450, 2, 7, 2)}
# 15b's adjoint rows beside cuDNN, by dtype: the top of the cluster walk and
# the grid walk's first timed H.
TIMED_ADJ_HS = {torch.float32: (376, 512), torch.bfloat16: (450, 512)}
# Lanes of 15c's and 16c's CPU side (at H=256 four took 93.1 s on the 8
# host cores, at H=512 two took 53.4 s at B=16), and the batch of their
# card-vs-CPU steps (at H=512 and B=64 two lanes took 177 s there, one lane
# at B=16 19.7 s at H=256 and 34.9 s at H=512, the script's largest CPU
# parts on a host that took it past 1200 s).
BIG_H_CPU_FOLDS = 1
WIDE_PARITY_BATCH = 8


def itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


@functools.cache
def entry_limit(name: str, dtype) -> int:
    """The largest H of the entry's one-block and cluster design in this
    dtype (past it the streamed walk runs: phase 16)."""
    item = itemsize(dtype)
    streamed = ((lambda h, i: not gru_cuda.adj_walk_takes(h, i)) if name in ADJOINTS
                else gru_cuda.walk_streamed)
    hidden = 1
    while not streamed(hidden + 1, item):
        hidden += 1
    return hidden


def stream_limit(name: str, dtype) -> int:
    """The largest H the entry takes in this dtype (the streamed walk's:
    gru_cuda.walk_max_hidden / adj_max_hidden)."""
    item = itemsize(dtype)
    return gru_cuda.adj_max_hidden(item) if name in ADJOINTS else gru_cuda.walk_max_hidden(item)


def entry_dtypes(name: str):
    return (torch.float32,) if name in ("gru_bifwd", "gru_bibwd") else (torch.float32,
                                                                        torch.bfloat16)


def entry_inputs(name: str, t: int, b: int, h: int, dtype, seed: int, reverse: bool,
                 lanes: int = 2):
    """Inputs of one entry on the card: one lane (gru_fwd, gru_bwd), `lanes`
    (the _fb entries), or the fused pair's two directions."""
    lanes = lanes if name.endswith("_fb") else None
    if name in ("gru_bifwd", "gru_bibwd"):
        return fused_inputs(t, b, h, seed, adjoint=name == "gru_bibwd")
    if name in ADJOINTS:
        return bwd_inputs(lanes, t, b, h, dtype, seed, reverse=reverse)
    return kernel_inputs(lanes, t, b, h, dtype, seed)


def call_entry(fn, name: str, args, reverse: bool):
    """fn (an entry's wrapper or plain version) on args; the fused pair
    takes no direction."""
    if name in ("gru_bifwd", "gru_bibwd"):
        return fn(*args)
    return fn(*args, reverse=reverse)


def cluster_plan(name: str, lanes: int, batch: int, hidden: int, dtype,
                 n_steps: int = SERVE_T) -> str:
    """The entry's plan at this shape (gru_cuda.walk_plan / adj_plan)."""
    item = itemsize(dtype)
    plan = (gru_cuda.adj_plan(batch, lanes, n_steps, hidden, item) if name in ADJOINTS
            else gru_cuda.walk_plan(batch, lanes, hidden, item))
    if plan["instantiation"] == "grid":
        return (f"grid, groups of {plan['cluster']} CTAs of {plan['resident']} units and "
                f"{plan['threads']} threads, {plan['groups']} groups at once, work items of "
                f"{plan['rows']} rows, {plan['shared_bytes']} bytes a CTA")
    text = (f"{plan['instantiation']}, cluster of {plan['cluster']}, row tile {plan['rows']}, "
            f"{plan['shared_bytes']} bytes a CTA")
    if plan["instantiation"] == "streamed":
        text += f", W of {plan['resident']} units resident, {plan['streamed']} streamed a CTA"
    return text


def cluster_formulas() -> None:
    """The cluster walk's C formulas against gru_cuda's twins for every H up
    to past both limits, both dtypes: cluster sizes, per-CTA shared bytes
    (row tiles 1, 2, 4), row tiles at 1, 2, 5, 15 and 60 lanes, the
    adjoint's whole plan (its cluster and row tile among it) past H = 64
    at B=37 and 2 lanes and B=64 and 5 and 15 lanes; and every unit of H in
    exactly one CTA's slice. Then ptxas's registers and spills of the
    cluster instantiations (build_phase fails on any spill)."""
    fwd, bwd = gru_cuda._library(), gru_cuda._bwd_library()
    for bf16, item in ((0, 4), (1, 2)):
        for h in range(1, 560):
            pairs = [(f"gru_walk_cluster_size({h}, {bf16})", fwd.gru_walk_cluster_size(h, bf16),
                      gru_cuda.walk_cluster_size(h, item)),
                     (f"gru_adj_cluster_size({h}, {bf16})", bwd.gru_adj_cluster_size(h, bf16),
                      gru_cuda.adj_cluster_size(h, item)),
                     (f"gru_adj_shared_bytes({h}, {bf16}, 1)", bwd.gru_adj_shared_bytes(h, bf16, 1),
                      gru_cuda.adj_shared_bytes(h, item, 1))]
            pairs += [(f"gru_walk_shared_bytes({h}, {bf16}, {r})",
                       fwd.gru_walk_shared_bytes(h, bf16, r), gru_cuda.walk_shared_bytes(h, item, r))
                      for r in (1, 2, 4)]
            if h % 7 == 0 or h in LARGE_HS:
                pairs += [(f"gru_walk_row_tile({b}, {f}, {h}, {bf16})",
                           fwd.gru_walk_row_tile(b, f, h, bf16),
                           gru_cuda.walk_row_tile(b, f, h, item))
                          for b in (1, 64, 65, 256) for f in (1, 2, 5, 15, 60)]
            for what, c_val, py_val in pairs:
                if c_val != py_val:
                    raise AssertionError(f"{what}: C says {c_val}, wrapper {py_val}")
            for k in {gru_cuda.walk_cluster_size(h, item), gru_cuda.adj_cluster_size(h, item)}:
                if k:
                    units = gru_cuda.cluster_units(h, k)
                    owners = [j // units for j in range(h)]
                    if owners != sorted(owners) or max(owners) >= k:
                        raise AssertionError(f"H={h}, cluster {k}: a unit outside the cluster")
    for name in ("gru_fwd", "gru_bwd"):
        for kernel, props, regs in PTXAS_KERNEL.findall(_build.build_log(name)):
            short = short_kernel_name(kernel)
            if short.startswith("gru_walk_cluster_kernel<") or (
                    short.startswith("gru_adj_walk_kernel<") and short.endswith(", 1>")):
                print(f"  ptxas {name} cluster walk: {short}: {regs} registers, {props}")
    limits = {str(d)[6:]: (gru_cuda.walk_max_hidden(itemsize(d)),
                           gru_cuda.adj_max_hidden(itemsize(d)))
              for d in (torch.float32, torch.bfloat16)}
    plans, costs = adjoint_plan_formulas()
    print(f"  cluster walk: C and wrapper agree on cluster sizes, per-CTA shared memory and "
          f"row tiles for H = 1-559, on {plans} adjoint plans (H = 1-1100, B = 1, 37, 64, 256, "
          f"1, 2 and 15 lanes, both dtypes) and on {costs} candidates' modelled costs; limits "
          f"(forward, adjoint): {limits}")


PLAN_BATCHES, PLAN_LANES = (1, ROW_TILE_B, SERVE_B, 256), (1, 2, SWEEP_F)


def adjoint_plan_formulas() -> tuple[int, int]:
    """The adjoint's C plan (gru_adj_plan: adj_choose's instantiation and
    tile, shared bytes, workspace) against gru_cuda.adj_plan at every H of
    1-1100, B in PLAN_BATCHES and lanes in PLAN_LANES, both dtypes; and
    every candidate's modelled cost and waves (gru_adj_candidate_plan)
    against adj_candidate_plan at each 35th H past 64 and CANDIDATE_HS.
    Returns the counts of plans and candidates checked."""
    plans = costs = 0
    for item in (4, 2):
        for h in range(1, 1101):
            for b in PLAN_BATCHES:
                for f in PLAN_LANES:
                    got = gru_cuda.c_plan(True, b, f, h, item, SERVE_T)
                    want = gru_cuda.adj_plan(b, f, SERVE_T, h, item)
                    if got != want:
                        raise AssertionError(f"adjoint plan B={b} F={f} H={h} itemsize={item}: "
                                             f"C {got}, wrapper {want}")
                    plans += 1
                    if h > gru_cuda.WALK_REG_MAX_HIDDEN and (
                            h % 35 == 0 or h in CANDIDATE_HS[torch.float32]
                            or h in CANDIDATE_HS[torch.bfloat16]):
                        for cand in gru_cuda.adj_candidates(b, f, h, item):
                            got = gru_cuda.c_candidate_plan(b, f, SERVE_T, h, item, *cand)
                            want = gru_cuda.adj_candidate_plan(b, f, SERVE_T, h, item, *cand)
                            if got != want:
                                raise AssertionError(f"candidate {cand} B={b} F={f} H={h} "
                                                     f"itemsize={item}: C {got}, wrapper {want}")
                            costs += 1
    return plans, costs


def entry_vs_plain(tag: str, name: str, t: int, b: int, h: int, dtype, reverse: bool,
                   lanes: int = 2, args=None) -> None:
    """The entry's wrapper on the card against its plain version on the
    same inputs (TOL / BWD_TOL; the fused pair's two directions each on
    their own), printing the largest differences and the plan; the _fb
    entries at `lanes` lanes; `args` (default: entry_inputs at seed H + T
    + B) the inputs."""
    adjoint = name in ADJOINTS
    fused = name in ("gru_bifwd", "gru_bibwd")
    lanes = lanes if (name.endswith("_fb") or fused) else 1
    if args is None:
        args = entry_inputs(name, t, b, h, dtype, seed=h + t + b, reverse=reverse, lanes=lanes)
    got = call_entry(WRAPPERS[name][0], name, args, reverse)
    torch.cuda.synchronize()
    want = call_entry(WRAPPERS[name][1], name, args, reverse)
    got = got if adjoint else (got,)
    want = want if adjoint else (want,)
    outs = ("dxg", "dW", "db", "dh0") if adjoint else ("ys",)
    errs = []
    for o, g, w in zip(outs, got, want):
        if g.shape != w.shape:
            raise AssertionError(f"{name} {o}: {list(g.shape)}")
        tol = (BWD_TOL[dtype][o in ("dW", "db")] if adjoint else TOL[dtype])
        errs.append((g.float() - w.float()).abs().max().item())
        # the fused pair's two directions on their own: streams [T, 2, B, .],
        # per-lane outputs [2, ...]
        parts = ([(g[:, d], w[:, d]) for d in (0, 1)] if fused and o in ("dxg", "ys")
                 else [(g[d], w[d]) for d in (0, 1)] if fused else [(g, w)])
        for gp, wp in parts:
            torch.testing.assert_close(
                gp.float(), wp.float(), **tol,
                msg=lambda m, o=o: f"{name} H={h} B={b} T={t} {o}: {m}")
    print(f"{tag} {name}: F={lanes} T={t} B={b} H={h} {str(dtype)[6:]} reverse={reverse}: "
          "max|d| " + ", ".join(f"{o} {e:.3e}" for o, e in zip(outs, errs))
          + f" ({cluster_plan(name, lanes, b, h, dtype, t)})")


def large_walks_phase() -> None:
    """15a: all six entries at H in LARGE_HS and at the cluster design's
    limit, f32 and bf16 where taken, T=480 B=64 both directions; at BIG_H
    also B=1, B=256 and T=1; each against its plain version (TOL / BWD_TOL;
    the fused pair's adjoint per direction). dW and db bitwise over two runs
    at BIG_H. (Past the cluster design's limit: phase 16.)"""
    t0 = time.perf_counter()
    for name in WRAPPERS:
        adjoint = name in ADJOINTS
        fused = name in ("gru_bifwd", "gru_bibwd")
        for dtype in entry_dtypes(name):
            limit = entry_limit(name, dtype)
            shapes = [(SERVE_T, SERVE_B, h) for h in LARGE_HS + (limit,)]
            shapes += [(SERVE_T, 1, BIG_H), (SERVE_T, 256, BIG_H), (1, SERVE_B, BIG_H)]
            shapes = [(t, b, h, 2) for t, b, h in shapes]
            if adjoint:
                shapes.append((SERVE_T, ROW_TILE_B, BIG_H, 2))
            if name == "gru_bwd_fb":
                shapes += [(SERVE_T, SERVE_B, TILED_ONE_BLOCK_H, SWEEP_F),
                           (SERVE_T, SERVE_B, BIG_H, SWEEP_F)]
            for t, b, h, lanes in shapes:
                # the sweep's lanes in one direction: the row tile's logic
                # is the same in both, which the other shapes check
                for reverse in ((False,) if fused or lanes == SWEEP_F else (False, True)):
                    entry_vs_plain("15a", name, t, b, h, dtype, reverse, lanes=lanes)
            if adjoint:
                for lanes in (2, SWEEP_F) if name == "gru_bwd_fb" else (2,):
                    args = entry_inputs(name, SERVE_T, SERVE_B, BIG_H, dtype, seed=3,
                                        reverse=False, lanes=lanes)
                    check_deterministic(name, WRAPPERS[name][0], args,
                                        f"15a F={lanes} H={BIG_H} {str(dtype)[6:]}")
                    del args
                moved_shapes_phase(name, dtype)
            torch.cuda.empty_cache()
    print(f"15a: {time.perf_counter() - t0:.1f} s")


def parent_choice(batch: int, lanes: int, hidden: int, item: int) -> tuple:
    """The adjoint walk the parent commit ran at this shape (above H = 64):
    the one-block or cluster walk up to its limit (bf16: H = 450), at the
    tile of the fewest waves by the plan's arithmetic (adj_waves), then
    the grid walk where grid_plan takes the shape, the streamed walk
    elsewhere; as gru_cuda.adj_choice's (instantiation, tile)."""
    if gru_cuda.adj_walk_takes(hidden, item) and (item == 4 or hidden <= 450):
        k, r = min(gru_cuda.adj_walk_tiles(hidden, item),
                   key=lambda kr: (gru_cuda.adj_waves(batch, lanes, hidden, item, *kr), *kr))
        return ("one block" if k == 1 else "cluster"), (k, r)
    grid = gru_cuda.grid_plan(batch, lanes, hidden, item, adjoint=True)
    return ("grid", (grid["ctas"], grid["rows"])) if grid else ("streamed", None)


def moved_shapes(name: str, dtype) -> list[tuple[int, int, int]]:
    """(B, lanes, H) of the entry at T=480 where the plan's choice is not the
    parent commit's: the H of CANDIDATE_HS and AB_HS at B=64 and the
    entry's lanes, and for gru_bwd_fb also at B=37 two lanes and B=64 15
    lanes."""
    item = itemsize(dtype)
    shapes = [(SERVE_B, entry_lanes(name))]
    if name == "gru_bwd_fb":
        shapes += [(ROW_TILE_B, 2), (SERVE_B, SWEEP_F)]
    hs = sorted(set(CANDIDATE_HS[dtype]) | set(AB_HS[dtype]))
    return [(b, f, h) for b, f in shapes for h in hs
            if gru_cuda.adj_choice(b, f, h, item)[:2] != parent_choice(b, f, h, item)]


def moved_shapes_phase(name: str, dtype) -> None:
    """15a: the adjoint at every shape whose choice moved (moved_shapes), at
    T=MOVED_T, against its plain version under BWD_TOL, and dW and db
    bitwise over two runs there."""
    for b, f, h in moved_shapes(name, dtype):
        args = entry_inputs(name, MOVED_T, b, h, dtype, seed=5, reverse=False, lanes=f)
        entry_vs_plain("15a moved", name, MOVED_T, b, h, dtype, False, lanes=f, args=args)
        check_deterministic(name, WRAPPERS[name][0], args,
                            f"15a moved B={b} F={f} H={h} {str(dtype)[6:]} (parent "
                            f"{parent_choice(b, f, h, itemsize(dtype))})")
        del args
        torch.cuda.empty_cache()


def time_entry(tag: str, name: str, dtype, h: int, per_block: int = 20,
               blocks: int = 5) -> float:
    """One entry at T=480 B=64 (two lanes for the _fb entries, the pair's
    two directions): kernel ms (median of `blocks` blocks of `per_block`
    calls), us per dependent step, the bound (6 H^2 FLOPs a row-step
    forward, 12 H^2 adjoint, with the gate math, or the bytes), the plain
    version (one call), cuDNN's nn.GRU at the same H (one direction, or
    bidirectional for two lanes; as many calls as the kernel's where fewer
    than 20 a block), the plan and its waves.
    Returns the kernel ms."""
    adjoint = name in ADJOINTS
    lanes = 2 if name.endswith("_fb") or name in ("gru_bifwd", "gru_bibwd") else None
    library_block = None if per_block >= 20 else per_block
    args = entry_inputs(name, SERVE_T, SERVE_B, h, dtype, seed=7, reverse=False)
    wrapper, plain_fn = WRAPPERS[name]
    ms = median_ms(lambda: wrapper(*args), per_block=per_block, blocks=blocks,
                   warmup=1 if per_block < 20 else 2)
    plain_ms = median_ms(lambda: plain_fn(*args), per_block=1, blocks=1, warmup=0)
    if adjoint:
        b_ms, b_by = bwd_bound_ms(lanes, SERVE_T, SERVE_B, h, dtype, products=2)
        lib_ms = cudnn_bwd_ms(lanes, SERVE_T, SERVE_B, h, dtype, per_block=library_block,
                              blocks=blocks)
    else:
        b_ms, b_by = bound_ms(lanes, SERVE_T, SERVE_B, h, dtype)
        lib_ms = cudnn_ms(lanes, SERVE_T, SERVE_B, h, dtype, per_block=library_block,
                          blocks=blocks)
    f = lanes or 1
    print(f"{tag} {name} {str(dtype)[6:]} F={f} T={SERVE_T} B={SERVE_B} H={h}: "
          f"kernel {ms:.4f} ms ({ms / SERVE_T * 1e3:.3f} us per dependent step; "
          f"{cluster_plan(name, f, SERVE_B, h, dtype)}; "
          f"{waves(adjoint, SERVE_B, f, h, dtype)}), plain {plain_ms:.3f} ms, "
          f"cuDNN GRU {'backward ' if adjoint else ''}{lib_ms:.4f} ms, bound "
          f"{b_ms:.5f} ms ({b_by}), {b_ms / ms:.2%} of bound")
    del args
    return ms


def adjoint_candidates() -> list[dict]:
    """15b: every candidate the plan weighs (gru_cuda.adj_candidates) at
    each H of CANDIDATE_HS and (B, lanes) of CANDIDATE_SHAPES, forced
    (gru_backward_candidate, the LaneMajor walk of gru_bwd_fb): first at
    T=CANDIDATE_CHECK_T against the plain version (BWD_TOL), then at T=480
    the walk alone, by CUDA events (the median of 3 calls after the
    candidate's whole call):
    us a step, beside its waves by the plan's arithmetic, by the model and
    by the card (cudaOccupancyMaxActiveClusters; the grid walk: rounds of
    work items) and the model's us a step; then whether the plan's choice
    is the fastest or within CHOICE_SLACK of it. Returns one dict a
    candidate (what the model's constants are fitted to)."""
    t0 = time.perf_counter()
    lib = gru_cuda._bwd_library()
    rows, within, shapes = [], 0, 0
    for dtype, hs in CANDIDATE_HS.items():
        item, bf16 = itemsize(dtype), int(dtype == torch.bfloat16)
        for h in hs:
            for b, lanes in CANDIDATE_SHAPES:
                cands = gru_cuda.adj_candidates(b, lanes, h, item)
                kind, tile, _ = gru_cuda.adj_choice(b, lanes, h, item)
                small = bwd_inputs(lanes, CANDIDATE_CHECK_T, b, h, dtype, seed=h + b + lanes)
                want = gru_cuda.gru_backward_fb_plain(*small)
                for cand in cands:
                    got, _ = gru_cuda.gru_backward_candidate(*small, *cand)
                    for o, g, w in zip(("dxg", "dW", "db", "dh0"), got, want):
                        torch.testing.assert_close(
                            g.float(), w.float(), **BWD_TOL[dtype][o in ("dW", "db")],
                            msg=lambda m, o=o, c=cand: f"15b {c} F={lanes} B={b} H={h} {o}: {m}")
                del small, want, got
                args = bwd_inputs(lanes, SERVE_T, b, h, dtype, seed=h + b + lanes)
                times = {}
                for cand in cands:
                    # The candidate's whole call has just run its walk: no warm-up.
                    _, walk = gru_cuda.gru_backward_candidate(*args, *cand)
                    ms = median_ms(walk, per_block=1, blocks=3, warmup=0)
                    del walk
                    plan = gru_cuda.adj_candidate_plan(b, lanes, SERVE_T, h, item, *cand)
                    at_once = lib.gru_adj_candidate_active(
                        b, lanes, h, bf16, gru_cuda.INSTANTIATIONS.index(cand[0]), *cand[1:])
                    items = -(-b // plan["rows"]) * lanes
                    card_waves = -(-items // at_once) if at_once > 0 else None
                    chosen = (cand[0], cand[1:]) == (kind, tile)
                    times[cand] = ms
                    rows.append(dict(dtype=str(dtype)[6:], h=h, b=b, lanes=lanes, kind=cand[0],
                                     cluster=cand[1], rows=cand[2], us=ms / SERVE_T * 1e3,
                                     waves=plan["waves"], cost_waves=plan["cost_waves"],
                                     card_waves=card_waves, at_once=at_once,
                                     per_sm=plan["per_sm"], model_us=plan["cost"] / 1e6,
                                     chosen=chosen))
                    print(f"15b candidate {str(dtype)[6:]} H={h} B={b} F={lanes} "
                          f"{cand[0]} {cand[1]}x{cand[2]}: walk {ms:.4f} ms "
                          f"({ms / SERVE_T * 1e3:.3f} us a step); waves {plan['waves']} "
                          f"(plan), {plan['cost_waves']} (model), {card_waves} (card: "
                          f"{at_once} at once); model {plan['cost'] / 1e6:.3f} us a step"
                          + (" <- the plan's choice" if chosen else ""))
                del args
                torch.cuda.empty_cache()
                best = min(times, key=times.get)
                mine = times[next(c for c in times if (c[0], c[1:]) == (kind, tile))]
                shapes += 1
                within += mine <= CHOICE_SLACK * times[best]
                print(f"15b choice {str(dtype)[6:]} H={h} B={b} F={lanes}: the plan takes "
                      f"{kind} {tile[0]}x{tile[1]} ({mine:.4f} ms), the fastest {best[0]} "
                      f"{best[1]}x{best[2]} ({times[best]:.4f} ms): {mine / times[best]:.3f}x")
    print(f"15b: the plan's choice the fastest or within {CHOICE_SLACK - 1:.0%} of it at "
          f"{within} of {shapes} shapes; {len(rows)} candidates in "
          f"{time.perf_counter() - t0:.1f} s")
    return rows


# The clock64() stamps of adjoint_step_split's copy of gru_bwd.cu: each
# (anchor, text put after it) in gru_adj_walk_kernel. Thread 0 of the first
# CTA sums, over the steps, the cycles from a step's start to its dg_lo
# stored (formation and exchange), to the barrier passed, to the dot done
# and to the butterfly done, and writes the four sums and the steps to
# adj_clock.
STEP_CLOCK = (
    ("""template <typename T, typename Layout, int R, bool kRegs, bool kCluster>
__global__ void __launch_bounds__(""", None),
    ("""  float dh = 0.0f;
  for (int step = 0; step < n_steps; ++step) {
""", """    long long clk_t0 = clock64();
"""),
    ("""      dht_at(step, pr)[pkl] = dht;
    }
""", """    long long clk_t1 = clock64();
"""),
    ("""      named_barrier(kDotBarrier, dot_threads);
    }
    // dh[r][k] = dg_lo[r] @ W[:, k] for the group's units.
""", """    long long clk_t2 = clock64();
"""),
    ("""    float sum[N];  // pair q = r U + u
""", None),
    ("""    if (pair) dh = dhz + sum[0];
""", """    long long clk_t4 = clock64();
    clk[0] += clk_t1 - clk_t0;
    clk[1] += clk_t2 - clk_t1;
    clk[2] += clk_t3 - clk_t2;
    clk[3] += clk_t4 - clk_t3;
"""),
    ("""  if (pair) dh0[(size_t(lane) * batch + row0 + pr) * H + pk] = dh;
""", """  if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0) {
    for (int i = 0; i < 4; ++i) adj_clock[i] = clk[i];
    adj_clock[4] = n_steps;
  }
"""))


def step_clock_source() -> str:
    """gru_bwd.cu with STEP_CLOCK's stamps, adj_clock and its reader
    gru_adj_clock (each anchor found once)."""
    src = (_build.CSRC / "gru_bwd.cu").read_text()
    for i, (anchor, text) in enumerate(STEP_CLOCK):
        if src.count(anchor) != 1:
            raise AssertionError(f"step clock: anchor {i} is not in gru_bwd.cu once")
        if i == 0:
            src = src.replace(anchor, "__device__ long long adj_clock[5];\n" + anchor)
        elif i == 4:
            src = src.replace(anchor, "    long long clk_t3 = clock64();\n" + anchor)
        else:
            src = src.replace(anchor, anchor + text)
    src = src.replace("  float dh = 0.0f;\n  for (int step = 0; step < n_steps; ++step) {\n",
                      "  long long clk[4] = {0, 0, 0, 0};\n"
                      "  float dh = 0.0f;\n  for (int step = 0; step < n_steps; ++step) {\n")
    return src + ("\nextern \"C\" int gru_adj_clock(long long* out) {\n"
                  "  return int(cudaMemcpyFromSymbol(out, adj_clock, 5 * sizeof(long long)));\n"
                  "}\n")


_STEP_CLOCK: dict = {}


def start_step_clock_build() -> None:
    """Start nvcc on step_clock_source's copy (adjoint_step_split's) beside
    the shipped build, into a temporary directory."""
    tmp = Path(tempfile.mkdtemp(prefix="adj_clock_"))
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, tmp)
    (tmp / "gru_bwd.cu").write_text(step_clock_source())
    so = tmp / "libgru_bwd_clock.so"
    proc = subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                             str(tmp / "gru_bwd.cu")], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    _STEP_CLOCK.update(dir=tmp, so=so, proc=proc, t0=time.perf_counter())


def finish_step_clock_build() -> None:
    """Wait for the copy's nvcc; raise with its output if it failed."""
    proc = _STEP_CLOCK.get("proc")
    if proc is None:
        return
    log, _ = proc.communicate()
    _STEP_CLOCK["proc"] = None
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the step clock copy:\n{log}")
    print(f"build: the step clock copy of gru_bwd.cu in "
          f"{time.perf_counter() - _STEP_CLOCK['t0']:.1f} s")


def adjoint_step_split() -> None:
    """15b: one step of the cluster walk split into four parts at
    STEP_SPLITS (f32 H=256 at 15 lanes, K=5 R=4; bf16 H=450 at 2 lanes, K=7
    R=2), in the copy of gru_bwd.cu with clock64() stamps (STEP_CLOCK): the
    pairs' dg_lo formation and its stores into every CTA, the cluster
    barrier, the dot, and the butterfly, cycles a step of thread 0 of the
    first CTA; and the copy's walk and the shipped walk's, us a step (CUDA
    events) over the card's waves of clusters, so the parts of the shipped
    step of one wave follow."""
    finish_step_clock_build()
    lib = ctypes.CDLL(str(_STEP_CLOCK["so"]))
    lib.gru_adj_clock.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    lib.gru_adj_clock.restype = ctypes.c_int
    shipped = gru_cuda._bwd_library()
    for name in ("gru_adj_candidate",):
        getattr(lib, name).argtypes = getattr(shipped, name).argtypes
        getattr(lib, name).restype = getattr(shipped, name).restype
    for dtype, (h, lanes, k, r) in STEP_SPLITS.items():
        args = bwd_inputs(lanes, SERVE_T, SERVE_B, h, dtype, seed=17)
        us = {}
        real = gru_cuda._bwd_library
        for what, use in (("shipped", shipped), ("stamped", lib)):
            gru_cuda._bwd_library = lambda use=use: use
            try:
                _, walk = gru_cuda.gru_backward_candidate(*args, "cluster", k, r)
                us[what] = median_ms(walk, per_block=1, blocks=3, warmup=1) / SERVE_T * 1e3
                del walk
            finally:
                gru_cuda._bwd_library = real
        out = (ctypes.c_longlong * 5)()
        if lib.gru_adj_clock(out) != 0:
            raise RuntimeError("gru_adj_clock failed")
        cycles = [v / out[4] for v in out[:4]]
        total = sum(cycles)
        at_once = shipped.gru_adj_candidate_active(SERVE_B, lanes, h, int(dtype == torch.bfloat16),
                                                   gru_cuda.INSTANTIATIONS.index("cluster"), k, r)
        waves = -(-(-(-SERVE_B // r) * lanes) // at_once)
        wave_us = us["shipped"] / waves
        parts = ("dg_lo formation and exchange", "cluster barrier", "dot", "butterfly")
        print(f"15b step split {str(dtype)[6:]} H={h} F={lanes} B={SERVE_B} cluster {k}x{r}: "
              + ", ".join(f"{p} {c:.0f} cycles ({c / total:.1%}; {c / total * wave_us:.3f} us)"
                          for p, c in zip(parts, cycles))
              + f"; {total:.0f} cycles a step of a wave; walk {us['stamped']:.3f} us a step "
              f"stamped, {us['shipped']:.3f} shipped, over {waves} wave(s): {wave_us:.3f} us a "
              "wave's step")
        del args
        torch.cuda.empty_cache()


# grid_step_split: a step of the grid walks (gru_walk_grid_kernel,
# gru_adj_grid_kernel) split by the GRID_STAMP clock64() stamps of
# csrc/gru_grid.cuh, in a copy of each source built with -DMMS_GRID_CLOCK
# beside the shipped library. Thread 0 of the first CTA sums, over its
# steps, the cycles between stamps: the parts are GRID_PARTS.
GRID_PARTS = ("loads before the K loop", "first tile", "rest of the K loop",
              "partials or butterfly", "gate math or dh, and the state's stores",
              "group barrier")
GRID_CLOCK_READER = ("\nextern \"C\" int gru_grid_clock(long long* out) {\n"
                     "  return int(cudaMemcpyFromSymbol(out, grid_clock, sizeof(grid_clock)));\n"
                     "}\n")


def has_grid_clock() -> bool:
    """Whether this tree's grid walks carry the GRID_STAMP stamps (trees
    from before them do not)."""
    return "GRID_STAMP(" in (_build.CSRC / "gru_fwd.cu").read_text()


_GRID_CLOCK: dict = {}


def start_grid_clock_build() -> None:
    """Start nvcc on the stamped copies of gru_fwd.cu and gru_bwd.cu
    (grid_step_split's: MMS_GRID_CLOCK defined, gru_grid_clock reading the
    stamps back), one process each, into a temporary directory."""
    tmp = Path(tempfile.mkdtemp(prefix="grid_clock_"))
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, tmp)
    procs = {}
    for name in ("gru_fwd", "gru_bwd"):
        (tmp / f"{name}.cu").write_text((_build.CSRC / f"{name}.cu").read_text()
                                        + GRID_CLOCK_READER)
        so = tmp / f"lib{name}_clock.so"
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-DMMS_GRID_CLOCK", "-o", str(so),
             str(tmp / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    _GRID_CLOCK.update(procs=procs, t0=time.perf_counter())


def finish_grid_clock_build() -> dict:
    """Wait for the copies' nvcc; raise with its output if one failed.
    Returns each copy's library path by source name."""
    procs = _GRID_CLOCK.pop("procs", None)
    if procs is None:
        return _GRID_CLOCK["libs"]
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the grid clock copy of {name}.cu:\n{log}")
        libs[name] = so
    _GRID_CLOCK["libs"] = libs
    print(f"build: the grid clock copies in {time.perf_counter() - _GRID_CLOCK['t0']:.1f} s")
    return libs


# grid_step_split's shapes at T=480 B=64: (entry, dtype, H, lanes); f32 H=381
# is GRID_FLOOR_H, the grid walk's first H, where its step is its fixed cost.
GRID_SPLITS = (("gru_fwd", torch.float32, 381, 1), ("gru_bwd", torch.float32, 381, 1),
               ("gru_fwd", torch.bfloat16, 1024, 1), ("gru_bwd", torch.bfloat16, 1024, 1),
               ("gru_bwd_fb", torch.bfloat16, 1024, 2), ("gru_bwd_fb", torch.float32, BIG_H, 15))


def _stamped(lib_path: Path, shipped: ctypes.CDLL) -> ctypes.CDLL:
    """The stamped copy loaded, with the shipped library's C signatures."""
    lib = ctypes.CDLL(str(lib_path))
    for name in ("gru_fwd", "gru_fwd_fb", "gru_bwd", "gru_bwd_fb", "gru_adj_candidate"):
        if hasattr(shipped, name):
            getattr(lib, name).argtypes = getattr(shipped, name).argtypes
            getattr(lib, name).restype = getattr(shipped, name).restype
    lib.gru_grid_clock.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    lib.gru_grid_clock.restype = ctypes.c_int
    return lib


def grid_step_split(out: Path | None = None) -> list[dict]:
    """A step of the grid walks split into GRID_PARTS at GRID_SPLITS, in the
    stamped copies (start_grid_clock_build): cycles a step of thread 0 of
    the first CTA over its steps (a step of one round of work items), and
    the walk's us a step by CUDA events, shipped and stamped (the forward:
    the entry; the adjoint: its walk alone, gru_backward_candidate), so the
    parts of the shipped step follow; beside them the entry's bound a step.
    Writes the rows to `out` as JSON when given."""
    libs = finish_grid_clock_build()
    real = {"gru_fwd": gru_cuda._library, "gru_bwd": gru_cuda._bwd_library}
    stamped = {name: _stamped(libs[name], real[name]()) for name in libs}
    rows = []
    for name, dtype, h, lanes in GRID_SPLITS:
        adjoint = name in ADJOINTS
        src = "gru_bwd" if adjoint else "gru_fwd"
        plan = entry_plan(name, lanes, SERVE_B, h, dtype)
        if plan["instantiation"] != "grid":
            raise AssertionError(f"grid split {name} H={h} F={lanes}: the plan runs "
                                 f"{plan['instantiation']}, not the grid walk")
        lead = None if name == "gru_fwd" or name == "gru_bwd" else lanes
        if adjoint:
            args = bwd_inputs(lanes, SERVE_T, SERVE_B, h, dtype, seed=19)
        else:
            args = kernel_inputs(lead, SERVE_T, SERVE_B, h, dtype, seed=19)
        us = {}
        for what, use in (("shipped", real[src]()), ("stamped", stamped[src])):
            attr = "_bwd_library" if adjoint else "_library"
            setattr(gru_cuda, attr, lambda use=use: use)
            try:
                if adjoint:
                    _, fn = gru_cuda.gru_backward_candidate(*args, "grid")
                else:
                    fn = functools.partial(WRAPPERS[name][0], *args)
                us[what] = median_ms(fn, per_block=1, blocks=3, warmup=1) / SERVE_T * 1e3
                del fn
            finally:
                setattr(gru_cuda, attr, real[src])
        clock = (ctypes.c_longlong * 7)()
        if stamped[src].gru_grid_clock(clock) != 0:
            raise RuntimeError("gru_grid_clock failed")
        steps = clock[6]
        rounds = steps // SERVE_T
        cycles = [v / steps for v in clock[:6]]
        total = sum(cycles)
        round_us = us["shipped"] / max(rounds, 1)
        bound = (bwd_bound_ms(lanes, SERVE_T, SERVE_B, h, dtype, products=2) if adjoint
                 else bound_ms(lead, SERVE_T, SERVE_B, h, dtype))
        bound_us = bound[0] / SERVE_T * 1e3
        rows.append(dict(name=name, dtype=str(dtype)[6:], h=h, lanes=lanes,
                         cycles=dict(zip(GRID_PARTS, cycles)),
                         total=total, rounds=rounds, us_shipped=us["shipped"],
                         us_stamped=us["stamped"], bound_us=bound_us, ctas=plan["cluster"],
                         groups=plan["groups"]))
        print(f"grid split {name} {str(dtype)[6:]} H={h} F={lanes} B={SERVE_B} "
              f"(group {plan['cluster']} CTAs, {plan['groups']} groups, {rounds} round(s)): "
              + ", ".join(f"{p} {c:.0f} cycles ({c / total:.1%}; {c / total * round_us:.3f} us)"
                          for p, c in zip(GRID_PARTS, cycles))
              + f"; {total:.0f} cycles a step; walk {us['stamped']:.3f} us a step stamped, "
              f"{us['shipped']:.3f} shipped: {round_us:.3f} us a round's step; the entry's "
              f"bound {bound_us:.3f} us a step ({bound[1]})")
        del args
        torch.cuda.empty_cache()
    if out is not None:
        out.write_text(json.dumps(rows))
    return rows


def adjoint_rows() -> None:
    """15b: each adjoint at T=480 B=64 and TIMED_ADJ_HS (time_entry: kernel
    ms, us a step, the bound, the plain version, cuDNN's nn.GRU backward,
    the plan and its waves), the median of 3 blocks of 5 calls."""
    for name in ADJOINTS:
        for dtype in entry_dtypes(name):
            for h in TIMED_ADJ_HS[dtype]:
                time_entry("15b", name, dtype, h, per_block=5, blocks=3)
    torch.cuda.empty_cache()


def adjoint_times(out: Path) -> None:
    """The adjoint entries at T=480 B=64 (time_entry's lanes) and every H of
    AB_HS, then gru_bwd_fb at the H=256 sweep's 15 lanes (f32 and bf16) and
    at the grouped sweep's 5 lanes of G*H = 192 (f32, as its walks run):
    kernel ms (the median of 3 blocks of 5 calls; 3 calls the F-lane
    shapes) with the plan's cluster and row tile, and for the F-lane
    shapes the walk's ms a call from a profiler split (adjoint_split).
    Written to `out` as a JSON list. Uses only what the parent commit's
    package has too, so that adjoint_ab can run it in either tree."""
    rows = []
    shapes = [(name, dtype, entry_lanes(name), h) for name in ADJOINTS
              for dtype in entry_dtypes(name) for h in AB_HS[dtype]]
    shapes += [("gru_bwd_fb", torch.float32, SWEEP_F, BIG_H),
               ("gru_bwd_fb", torch.bfloat16, SWEEP_F, BIG_H),
               ("gru_bwd_fb", torch.float32, SWEEP_F // FOLD_GROUP, FOLD_GROUP * SERVE_H)]
    for name, dtype, lanes, h in shapes:
        args = entry_inputs(name, SERVE_T, SERVE_B, h, dtype, seed=7, reverse=False,
                            lanes=lanes)
        fn = functools.partial(WRAPPERS[name][0], *args)
        wide = lanes > 2
        ms = median_ms(fn, per_block=3 if wide else 5, blocks=3, warmup=1)
        plan = gru_cuda.adj_plan(SERVE_B, lanes, SERVE_T, h, itemsize(dtype))
        walk = (adjoint_split(fn, lanes, SERVE_T, SERVE_B, h, dtype, f"{name} split")["walk"]
                if wide else None)
        rows.append(dict(name=name, dtype=str(dtype)[6:], lanes=lanes, h=h, ms=ms, walk_ms=walk,
                         cluster=plan["cluster"], rows=plan["rows"],
                         waves=waves(True, SERVE_B, lanes, h, dtype)))
        print(f"  {rows[-1]}")
        del args, fn
        torch.cuda.empty_cache()
    out.write_text(json.dumps(rows))


def grid_ab_shapes() -> list[tuple]:
    """grid_times' shapes at B=64, (entry, dtype, H, lanes): 16b's (every
    entry at STREAM_TIMED_HS, gru_fwd and gru_bwd f32 at GRID_FLOOR_H), every
    entry at WIDE_H and gru_bwd_fb at the H=256 sweep's 15 lanes."""
    shapes = [(name, dtype, h, entry_lanes(name)) for name in WRAPPERS
              for dtype in entry_dtypes(name) for h in (WIDE_H, *STREAM_TIMED_HS)]
    shapes += [(name, torch.float32, GRID_FLOOR_H, 1) for name in ("gru_fwd", "gru_bwd")]
    return shapes + [("gru_bwd_fb", dtype, BIG_H, SWEEP_F)
                     for dtype in (torch.float32, torch.bfloat16)]


# Steps of grid_times' outputs.
GRID_AB_T = 24


def grid_times(out: Path) -> None:
    """Each shape of grid_ab_shapes that runs a grid walk: the entry's ms at
    T=480 (median of 3 blocks of 3 calls), its plan's group, clusters and
    groups, and its outputs at T=GRID_AB_T from seeded inputs, saved beside
    `out` (out.stem + .<i>.pt); the rows written to `out` as JSON. Uses only
    what the parent commit's package has too, so that tree_ab can run it in
    either tree."""
    rows = []
    for i, (name, dtype, h, lanes) in enumerate(grid_ab_shapes()):
        plan = entry_plan(name, lanes, SERVE_B, h, dtype)
        if plan["instantiation"] != "grid":
            continue
        fn = WRAPPERS[name][0]
        args = entry_inputs(name, SERVE_T, SERVE_B, h, dtype, seed=7, reverse=False, lanes=lanes)
        ms = median_ms(functools.partial(fn, *args), per_block=3, blocks=3, warmup=1)
        del args
        small = entry_inputs(name, GRID_AB_T, SERVE_B, h, dtype, seed=13, reverse=False,
                             lanes=lanes)
        got = fn(*small)
        torch.save([g.cpu() for g in (got if isinstance(got, tuple) else (got,))],
                   out.with_suffix(f".{i}.pt"))
        rows.append(dict(i=i, name=name, dtype=str(dtype)[6:], lanes=lanes, h=h, ms=ms,
                         ctas=plan["cluster"], groups=plan["groups"]))
        print(f"  {rows[-1]}")
        del small, got
        torch.cuda.empty_cache()
    out.write_text(json.dumps(rows))


def tree_ab(parent: Path, out: Path, jobs: str, tag: str) -> list:
    """Run `jobs` (Python calling cs.<functions> on cs.Path(res), res the
    run's result stem) at the parent commit (`parent`: its tree, unpacked
    from git archive) and here, in turns parent, here, here, parent, each
    run a process of its own from its tree's root with that tree's package
    (this file loaded by path), TF32 off, its kernels built first, so both
    build and run their own kernels on this card. Returns the four runs'
    result stems."""
    here = Path(__file__).resolve()
    runs = []
    for i, tree in enumerate((parent, here.parent, here.parent, parent)):
        res = (out / f"{tag}_{i}").resolve()
        code = ("import importlib.util, torch; "
                f"spec = importlib.util.spec_from_file_location('chip_smoke', {str(here)!r}); "
                "cs = importlib.util.module_from_spec(spec); spec.loader.exec_module(cs); "
                "torch.backends.cuda.matmul.allow_tf32 = False; "
                "torch.backends.cudnn.allow_tf32 = False; "
                f"res = {str(res)!r}; cs._build.build(); " + jobs)
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-c", code], cwd=tree.resolve(), check=True,
                       env={**os.environ, "PYTHONPATH": str(tree.resolve())})
        print(f"{tag} run {i} ({'parent' if tree == parent else 'here'}): "
              f"{time.perf_counter() - t0:.1f} s")
        runs.append(res)
    return runs


def adjoint_ab(parent: Path, out: Path) -> None:
    """adjoint_times at the parent commit and here in turns (tree_ab); prints
    each shape's ms in the four runs and the ratio of the means (here /
    parent), and for the F-lane shapes the walk's. Run it from this tree's
    root:

        python -c "import chip_smoke as cs; from pathlib import Path; \
            cs.card(); cs.adjoint_ab(Path('output/parent'), Path('output'))"
    """
    runs = tree_ab(parent, out, "cs.adjoint_times(cs.Path(res + '.json'))", "adjoint_ab")
    runs = [json.loads(Path(str(r) + ".json").read_text()) for r in runs]
    for p0, h0, h1, p1 in zip(*runs):
        parent_ms, here_ms = (p0["ms"] + p1["ms"]) / 2, (h0["ms"] + h1["ms"]) / 2
        line = (f"adjoint_ab {h0['name']} {h0['dtype']} F={h0['lanes']} H={h0['h']}: parent "
                f"{p0['ms']:.4f} / {p1['ms']:.4f} ms (cluster {p0['cluster']}, row tile "
                f"{p0['rows']}; {p0['waves']}), here {h0['ms']:.4f} / {h1['ms']:.4f} ms "
                f"(cluster {h0['cluster']}, row tile {h0['rows']}; {h0['waves']}): "
                f"{here_ms / parent_ms:.3f}x")
        if h0["walk_ms"] and h1["walk_ms"] and p0["walk_ms"] and p1["walk_ms"]:
            line += (f"; walk parent {p0['walk_ms']:.4f} / {p1['walk_ms']:.4f}, here "
                     f"{h0['walk_ms']:.4f} / {h1['walk_ms']:.4f} ms")
        print(line)


def grid_ab(parent: Path, out: Path) -> None:
    """Both grid walks at the parent commit and here in turns (tree_ab): the
    first run of each tree whose sources carry the GRID_STAMP stamps splits
    a step (grid_step_split), every run times grid_ab_shapes (grid_times);
    prints each shape's ms in the four runs and the ratio of the means
    (here / parent), and whether its outputs at T=GRID_AB_T are the
    parent's bit for bit, else their largest difference. Run it from this
    tree's root as adjoint_ab."""
    jobs = ("first = res.endswith(('_0', '_1')) and cs.has_grid_clock(); "
            "cs.start_grid_clock_build() if first else None; "
            "cs.grid_step_split(cs.Path(res + '.split.json')) if first else None; "
            "cs.grid_times(cs.Path(res + '.json'))")
    runs = tree_ab(parent, out, jobs, "grid_ab")
    rows = [json.loads(Path(str(r) + ".json").read_text()) for r in runs]
    for p0, h0, h1, p1 in zip(*rows):
        parent_ms, here_ms = (p0["ms"] + p1["ms"]) / 2, (h0["ms"] + h1["ms"]) / 2
        want = torch.load(Path(str(runs[0]) + f".{p0['i']}.pt"))
        got = torch.load(Path(str(runs[1]) + f".{h0['i']}.pt"))
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        diff = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
        print(f"grid_ab {h0['name']} {h0['dtype']} F={h0['lanes']} H={h0['h']}: parent "
              f"{p0['ms']:.4f} / {p1['ms']:.4f} ms ({p0['ctas']} CTAs x {p0['groups']} groups), "
              f"here {h0['ms']:.4f} / {h1['ms']:.4f} ms ({h0['ctas']} CTAs x {h0['groups']} "
              f"groups): {here_ms / parent_ms:.3f}x; outputs "
              + ("bitwise the parent's" if same else f"differ from the parent's by {diff:.3g}"))


def big_sweep_phase(data: Path, root: Path) -> dict[str, int]:
    """15c: the sweep CLI at model.gru_hidden_size=BIG_H on phase 7's data,
    1 epoch, f32 auto (first 3 steps card vs CPU at B=8 under TRAIN_TOL, exact
    launches, finite folds, step profile); then a fold's Predictor at BIG_H,
    counted, against the same Predictor on the CPU (PROB_ATOL). Returns the
    CLI's launches."""
    argv = ["--set", f"data_path={data}", "--set", f"model.gru_hidden_size={BIG_H}"]
    launches, run_dir = sweep_phase("float32", argv, root, f"sweep_h{BIG_H}", db_step=False,
                                    epochs=1, cpu_folds=BIG_H_CPU_FOLDS,
                                    parity_batch=WIDE_PARITY_BATCH)
    x = np.random.default_rng(15).standard_normal((70, 3, WINDOW_T)).astype(np.float32)
    card = Predictor.from_run(run_dir, "S2", device="cuda")
    gru_cuda.reset_launch_counts()
    # --- the main path: everything between reset and read is counted ---
    probs = card.predict_windows(x)
    counts = gru_cuda.launch_counts()
    # --------------------------------------------------------------------
    want = dict.fromkeys(KERNELS, 0)
    want["gru_fwd_fb"], want["gru_fwd"] = 2, 2   # 2 padded batches: layer 0, the pruned layer
    if counts != want:
        raise AssertionError(f"Predictor H={BIG_H}: launches {counts}, expected {want}")
    cpu = Predictor.from_run(run_dir, "S2", device="cpu").predict_windows(x)
    err = _check_probs(probs, cpu, len(x), PROB_ATOL["float32"], f"Predictor H={BIG_H}")
    print(f"15c Predictor H={BIG_H} fold S2: 70 windows, card vs CPU max|d| {err:.3e}, "
          f"launches {counts}")
    return launches


@contextlib.contextmanager
def fold_group(g: int | None):
    """MMS_GRU_FOLD_GROUP set to g (unset for None) for the span of the block."""
    saved = os.environ.get(gru_cuda.FOLD_GROUP_ENV)
    if g is None:
        os.environ.pop(gru_cuda.FOLD_GROUP_ENV, None)
    else:
        os.environ[gru_cuda.FOLD_GROUP_ENV] = str(g)
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(gru_cuda.FOLD_GROUP_ENV, None)
        else:
            os.environ[gru_cuda.FOLD_GROUP_ENV] = saved


@contextlib.contextmanager
def walk_shapes(seen: list):
    """Record (entry, lanes, H) of every gru_fwd_fb and gru_bwd_fb launch."""
    call = gru_cuda._call

    def recorder(lib, entry, tensors, ints):
        if entry in ("gru_fwd_fb", "gru_bwd_fb"):
            seen.append((entry, tensors[0].shape[0], tensors[0].shape[-1] // 3))
        return call(lib, entry, tensors, ints)

    gru_cuda._call = recorder
    try:
        yield seen
    finally:
        gru_cuda._call = call


def grouped_sweep_phase(data: Path, root: Path) -> dict[str, int]:
    """15d: MMS_GRU_FOLD_GROUP=FOLD_GROUP at F=15 (5 lanes of G*H = 192,
    float32 walks), f32 and bf16: the first 3 sweep steps (dropout 0) of all
    15 folds grouped against ungrouped on the card under TRAIN_TOL, with the
    lanes and H of every walk recorded; the CLI grouped for 1 epoch, counted
    (the ungrouped run's launches); the step ms of both, ungrouped, grouped,
    grouped, ungrouped. Returns the f32 CLI's launches."""
    first = None
    for dtype in ("float32", "bfloat16"):
        argv = ["--set", f"data_path={data}", "--set", f"model.dtype={dtype}",
                "--set", "trainer.epochs=1"]
        cfg = cli.load_config(cli.build_parser().parse_args(argv))
        staged = root / f"grouped_staged_{dtype}"
        staged.mkdir(parents=True)
        corpus = stage_corpus(cfg, staged)
        fb = build_fold_batch(corpus, list(cfg.subjects), cfg.val_fraction, cfg.seed)
        folds = len(fb.test_subjects)
        no_drop = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dropout=0.0))
        runs = {}
        for grouped in (False, True):
            seeds, rngs = fold_streams(cfg.seed, folds)   # the same weights and grid
            with fold_group(FOLD_GROUP if grouped else None), walk_shapes([]) as seen:
                g = gru_cuda.pick_group(folds)
                sweep = FoldSweep(corpus, fb, no_drop, "cuda", init_seeds=seeds)
                idx, w = sweep.to_device(sweep.train_grid(rngs))
                losses = [sweep.train_step(idx[:, s], w[:, s])[0].cpu().tolist()
                          for s in range(3)]
            runs[grouped] = (sweep.model, [v for row in losses for v in row], seen, g)
        (ref, ref_losses, seen_u, _), (grp, grp_losses, seen_g, g) = runs[False], runs[True]
        want = {(n, folds // g, g * cfg.model.gru_hidden_size) for n, _, _ in seen_g}
        if g != FOLD_GROUP or set(seen_g) != want or len(seen_g) != len(seen_u):
            raise AssertionError(f"grouped {dtype}: G={g}, walks {sorted(set(seen_g))}")
        loss_err, worst, share, ok = compare_steps(grp, grp_losses, ref.cpu(), ref_losses,
                                                   TRAIN_TOL[dtype], steps=3)
        summary = (f"losses max rel|d| {loss_err:.3e}, parameters max|d| {worst:.3e}, "
                   f"{share:.4%} beyond {TRAIN_TOL[dtype]['elem']}")
        if not ok:
            raise AssertionError(f"grouped {dtype}: grouped vs ungrouped beyond TRAIN_TOL: "
                                 f"{summary}")
        print(f"15d grouped {dtype}: first 3 sweep steps of {folds} folds, G={g} "
              f"({len(seen_g)} walks of {folds // g} lanes at H'={g * cfg.model.gru_hidden_size}"
              f" against {len(seen_u)} of {folds} at H={cfg.model.gru_hidden_size}) vs "
              f"ungrouped on the card: {summary}")
        del ref, grp, sweep, runs
        with fold_group(FOLD_GROUP):
            launches, _ = sweep_phase(dtype, ["--set", f"data_path={data}"], root,
                                      "grouped_sweep", corpus=corpus, parity=False,
                                      profile=False, db_step=False, epochs=1)
        first = first or launches
        windows = folds * cfg.trainer.batch_size
        sweeps = {}
        for grouped in (False, True, True, False):
            with fold_group(FOLD_GROUP if grouped else None):
                if grouped not in sweeps:
                    seeds, rngs = fold_streams(cfg.seed, folds)
                    sweep = FoldSweep(corpus, fb, cfg, "cuda", init_seeds=seeds)
                    sweeps[grouped] = (sweep, sweep.to_device(sweep.train_grid(rngs)))
                sweep, (idx, w) = sweeps[grouped]
                ms = median_ms(lambda: sweep.train_step(idx[:, 0], w[:, 0]), per_block=5,
                               blocks=3)
            print(f"15d sweep {dtype} F={folds} {'grouped G=3' if grouped else 'ungrouped'}: "
                  f"train step {ms:.3f} ms ({windows / ms * 1e3:.0f} windows/s)")
        with fold_group(FOLD_GROUP):
            sweep, (idx, w) = sweeps[True]
            trace(lambda: sweep.train_step(idx[:, 0], w[:, 0]), f"grouped {dtype} train step")
        del sweeps, sweep
        torch.cuda.empty_cache()
    return first


def phase15(root: Path, data: Path) -> dict[str, int]:
    """Phase 15 (module docstring): 15a the six entries past one block's
    shared memory against their plain versions, 15b the adjoints' times,
    15c the sweep and a Predictor at H=256, 15d fold grouping. Returns the
    launches of 15c's and 15d's f32 CLI runs (the main path of this
    phase)."""
    t_phase = time.perf_counter()
    root.mkdir()
    marks = [time.perf_counter()]
    cluster_formulas()
    large_walks_phase()
    marks.append(time.perf_counter())
    adjoint_candidates()
    adjoint_step_split()
    adjoint_rows()
    marks.append(time.perf_counter())
    big = big_sweep_phase(data, root)
    marks.append(time.perf_counter())
    grouped = grouped_sweep_phase(data, root)
    marks.append(time.perf_counter())
    split = ", ".join(f"15{k} {b - a:.1f} s" for k, a, b in zip("abcd", marks, marks[1:]))
    print(f"phase 15: {time.perf_counter() - t_phase:.1f} s ({split})")
    return {k: big[k] + grouped[k] for k in KERNELS}


# Phase 16: the streamed walks (every H past the cluster walk's limit: W
# streamed from L2 past a cluster's shared memory), the host window engine
# and trainer.remat.
WIDE_H = 512
STREAM_HS = {False: (381, 512, 768, 1024), True: (377, 451, 512, 768, 1024)}  # by "adjoint"
# 16b's H (the times at H = 512 are kept in PERF.md section 6).
STREAM_TIMED_HS = (1024,)
# 16b also times gru_fwd and gru_bwd in float32 at the first H of the grid
# walk, where a step's FMAs are few: its per-step cost is the walk's fixed
# one (the group barrier and the first tile's L2 round trip).
GRID_FLOOR_H = 381
WIDE_CPU_FOLDS = 1
# Steps of 16a's checks past the grid walk's limit (the streamed walks).
PAST_GRID_T = 16
# The streamed walks at T=480, B=64 as 16b timed them before the grid walk
# took these shapes (PERF.md section 6: NVIDIA H100 80GB HBM3, 700.00 W),
# ms a call by (entry, dtype, H); bf16 gru_fwd and gru_fwd_fb at H=512 ran
# the cluster walk.
STREAMED_MS = {
    ("gru_fwd", "float32", 512): 9.0800, ("gru_fwd", "bfloat16", 512): 6.7959,
    ("gru_fwd", "float32", 1024): 29.4845, ("gru_fwd", "bfloat16", 1024): 26.3508,
    ("gru_fwd_fb", "float32", 512): 18.2596, ("gru_fwd_fb", "bfloat16", 512): 10.3297,
    ("gru_fwd_fb", "float32", 1024): 63.7680, ("gru_fwd_fb", "bfloat16", 1024): 52.6791,
    ("gru_bifwd", "float32", 512): 18.2241, ("gru_bifwd", "float32", 1024): 64.7573,
    ("gru_bwd", "float32", 512): 34.7171, ("gru_bwd", "bfloat16", 512): 37.9117,
    ("gru_bwd", "float32", 1024): 109.9084, ("gru_bwd", "bfloat16", 1024): 95.3366,
    ("gru_bwd_fb", "float32", 512): 56.3667, ("gru_bwd_fb", "bfloat16", 512): 61.1349,
    ("gru_bwd_fb", "float32", 1024): 195.6502, ("gru_bwd_fb", "bfloat16", 1024): 161.1102,
    ("gru_bibwd", "float32", 512): 56.4506, ("gru_bibwd", "float32", 1024): 196.0654}


def entry_lanes(name: str) -> int:
    return 2 if name.endswith("_fb") or name in ("gru_bifwd", "gru_bibwd") else 1


def entry_plan(name: str, lanes: int, batch: int, hidden: int, dtype, n_steps: int = SERVE_T):
    item = itemsize(dtype)
    return (gru_cuda.adj_plan(batch, lanes, n_steps, hidden, item) if name in ADJOINTS
            else gru_cuda.walk_plan(batch, lanes, hidden, item))


@functools.cache
def grid_end(name: str, dtype) -> int:
    """The first H past the cluster design's limit at which the entry, at
    T=480 B=64 and its lanes, no longer runs the grid walk (the streamed
    walk runs there)."""
    hidden = entry_limit(name, dtype) + 1
    while entry_plan(name, entry_lanes(name), SERVE_B, hidden, dtype)["instantiation"] == "grid":
        hidden += 1
    return hidden


def stream_formulas() -> None:
    """16a: the C plans (gru_walk_plan, gru_adj_plan: instantiation, cluster
    or grid group, row tile or work item rows, resident and streamed units a
    CTA, shared bytes, workspace, the grid walk's groups at once and
    threads) against gru_cuda's twins for H = 1-2200 (past the grid walk's
    limit in both dtypes), both dtypes, at 1, 2, 15 and 60 lanes; then
    ptxas's registers of the grid and streamed instantiations (the build
    fails on any spill)."""
    shapes = ((64, 1), (64, 2), (64, 15), (1, 2), (256, 2), (64, 60))
    checked = 0
    for item in (4, 2):
        for h in range(1, 2201):
            for batch, lanes in (shapes if h % 5 == 0 else shapes[:2]):
                for adjoint in (False, True):
                    want = (gru_cuda.adj_plan(batch, lanes, SERVE_T, h, item) if adjoint
                            else gru_cuda.walk_plan(batch, lanes, h, item))
                    got = gru_cuda.c_plan(adjoint, batch, lanes, h, item, SERVE_T)
                    if got != want:
                        raise AssertionError(f"plan H={h} itemsize={item} B={batch} F={lanes} "
                                             f"adjoint={adjoint}: C {got}, wrapper {want}")
                    checked += 1
    for name in ("gru_fwd", "gru_bwd"):
        for kernel, props, regs in PTXAS_KERNEL.findall(_build.build_log(name)):
            short = short_kernel_name(kernel)
            if "grid" in short:
                print(f"  ptxas {name} grid walk: {short}: {regs} registers, {props}")
            elif ("stream" in short or "tiled" in short or "pad_rows" in short
                  or "transpose" in short):
                print(f"  ptxas {name} streamed walk: {short}: {regs} registers, {props}")
    limits = {str(d)[6:]: (gru_cuda.walk_max_hidden(itemsize(d)),
                           gru_cuda.adj_max_hidden(itemsize(d)))
              for d in (torch.float32, torch.bfloat16)}
    ends = {f"{n} {str(d)[6:]}": grid_end(n, d) for n in WRAPPERS for d in entry_dtypes(n)}
    print(f"16a: C and wrapper agree on {checked} plans for H = 1-2200; limits (forward, "
          f"adjoint): {limits}; first streamed H at B={SERVE_B} and each entry's lanes: {ends}")


def empty_entry_args(name: str, h: int, dtype) -> tuple:
    """Uninitialized inputs of an entry on the card at T=2, B=1 and H (for a
    check that reads shapes only)."""
    z = functools.partial(torch.empty, device="cuda")
    if name in ("gru_bifwd", "gru_bibwd"):
        args = (z(2, 2, 1, 3 * h), z(2, 3 * h, h), z(2, 3 * h), z(2, 1, h))
        return args + ((z(2, 2, 1, h), z(2, 2, 1, h)) if name == "gru_bibwd" else ())
    lead = (2,) if name.endswith("_fb") else ()
    args = (z(lead + (2, 1, 3 * h), dtype=dtype), z(lead + (3 * h, h), dtype=dtype),
            z(lead + (3 * h,), dtype=dtype), z(lead + (1, h)))
    if name in ADJOINTS:
        args += (z(lead + (2, 1, h), dtype=dtype), z(lead + (2, 1, h), dtype=dtype))
    return args


def stream_walks_phase() -> None:
    """16a: all six entries at STREAM_HS (H = 381 forward / 377 adjoint, the
    first f32 sizes past the cluster walk, 451 where the bf16 adjoint left
    it before its plan weighed a step's cost, 512, 768, 1024: the grid walk
    where the plan takes it), f32 and bf16 where taken,
    T=480 B=64; at H=512 also B=1, B=256 and T=1; at the first H past the
    grid walk's limit (grid_end: the streamed walk) at T=PAST_GRID_T; both
    directions at H=512 and past the limit, one elsewhere; each against its
    plain version (TOL / BWD_TOL,
    entry_vs_plain). gru_fwd_fb and gru_bwd_fb also at 15 lanes, H=512 (the
    grid walk's groups taking the lanes in turn, two passes of rows). dW and
    db bitwise over two runs at H=512 (grid) and past the grid walk's limit
    (streamed). Past the streamed walk's limit a ValueError before any
    launch, naming it."""
    t0 = time.perf_counter()
    for name in WRAPPERS:
        adjoint = name in ADJOINTS
        fused = name in ("gru_bifwd", "gru_bibwd")
        for dtype in entry_dtypes(name):
            shapes = [(SERVE_T, SERVE_B, h) for h in STREAM_HS[adjoint]]
            shapes += [(SERVE_T, 1, WIDE_H), (SERVE_T, 256, WIDE_H), (1, SERVE_B, WIDE_H),
                       (PAST_GRID_T, SERVE_B, grid_end(name, dtype))]
            for t, b, h in shapes:
                both = not fused and h in (WIDE_H, grid_end(name, dtype))
                for reverse in ((False, True) if both else (False,)):
                    entry_vs_plain("16a", name, t, b, h, dtype, reverse)
            if name.endswith("_fb") and dtype == torch.float32:
                entry_vs_plain("16a", name, SERVE_T, SERVE_B, WIDE_H, dtype, False, lanes=15)
            if adjoint:
                for t, h in ((SERVE_T, WIDE_H), (PAST_GRID_T, grid_end(name, dtype))):
                    args = entry_inputs(name, t, SERVE_B, h, dtype, seed=3, reverse=False)
                    check_deterministic(name, WRAPPERS[name][0], args,
                                        f"16a H={h} T={t} {str(dtype)[6:]} "
                                        f"({entry_plan(name, entry_lanes(name), SERVE_B, h, dtype, t)['instantiation']})")
                    del args
            limit = stream_limit(name, dtype)
            over = limit + 1
            args = empty_entry_args(name, over, dtype)
            before = gru_cuda.launch_counts()
            try:
                WRAPPERS[name][0](*args)
            except ValueError as e:
                if gru_cuda.launch_counts() != before or str(limit) not in str(e):
                    raise AssertionError(f"{name} H={over}: {e}; launches moved or no limit "
                                         "named") from e
                print(f"16a {name} {str(dtype)[6:]} H={over}: refused before any launch: {e}")
            else:
                raise AssertionError(f"{name} took H={over} {dtype}, past its limit {limit}")
            torch.cuda.empty_cache()
    print(f"16a: {time.perf_counter() - t0:.1f} s")


def stream_timings() -> None:
    """16b: each entry at H = STREAM_TIMED_HS (time_entry: kernel ms, us a
    step, the bound, the plain version, cuDNN's nn.GRU, the plan, its
    groups or clusters and rounds or waves) beside the streamed walk's time at
    the same shape, and the bytes a step reads from L2 in all CTAs: W (the
    streamed walk's streamed rows) and the state (the grid walk's exchange:
    every CTA reads its work item's whole h, or dg_lo, each step); then a
    step of both grid walks split by clock64() stamps (grid_step_split at
    GRID_SPLITS: its float32 H = GRID_FLOOR_H shapes are the walk's fixed
    cost a step); then a profile of one gru_bwd call at each H and dtype
    after a warm-up, split by kernel (pre-pass, walk, weight-gradient
    pass, reduction). (The one-block and cluster walks are re-timed at H =
    64 by the kernel phases, the adjoints' at H = 137-450 by 15b.)"""
    for name in WRAPPERS:
        adjoint = name in ADJOINTS
        lanes = entry_lanes(name)
        for dtype in entry_dtypes(name):
            for h in STREAM_TIMED_HS:
                ms = time_entry("16b", name, dtype, h, per_block=3, blocks=3)
                item = itemsize(dtype)
                plan = entry_plan(name, lanes, SERVE_B, h, dtype)
                if plan["instantiation"] == "grid":
                    kt = gru_cuda.grid_plan(SERVE_B, lanes, h, item, adjoint)["kt"]
                    k = -(-(3 * h if adjoint else h) // kt) * kt
                    ctas = plan["cluster"] * plan["groups"]
                    w_mb, state_mb = 0.0, ctas * plan["rows"] * k * item / 1e6
                    how = (f"{ctas} CTAs x {plan['rows']} rows x {k} x {item} bytes of state, "
                           "no W")
                else:
                    per_unit = (-(-3 * h // 4) * 4 if adjoint else 3 * (-(-h // 4) * 4)) * item
                    ctas = -(-SERVE_B // plan["rows"]) * lanes * plan["cluster"]
                    w_mb, state_mb = plan["streamed"] * per_unit * ctas / 1e6, 0.0
                    how = f"{plan['streamed']} units x {per_unit} bytes x {ctas} CTAs of W"
                before = STREAMED_MS.get((name, str(dtype)[6:], h))
                print(f"16b {name} {str(dtype)[6:]} H={h}: {plan['instantiation']} walk; read "
                      f"from L2 a step: W {w_mb:.2f} MB, state {state_mb:.2f} MB ({how}); streamed "
                      + (f"{before:.4f} ms, now {ms:.4f} ms ({before / ms:.2f}x)" if before
                         else "not measured at this shape"))
            torch.cuda.empty_cache()
    grid_step_split()
    for dtype in entry_dtypes("gru_bwd"):
        for h in STREAM_TIMED_HS:
            args = entry_inputs("gru_bwd", SERVE_T, SERVE_B, h, dtype, seed=11, reverse=False)
            adjoint_split(lambda: gru_cuda.gru_backward(*args), None, SERVE_T, SERVE_B, h, dtype,
                          "16b gru_bwd")
            del args
            torch.cuda.empty_cache()


def wide_sweep_phase(data: Path, root: Path) -> dict[str, int]:
    """16c: a fold's Predictor at model.gru_hidden_size=WIDE_H (random
    weights) against the same Predictor on the CPU (PROB_ATOL), counted;
    then the sweep at WIDE_H on phase 7's data, f32: the first 3 steps on
    the card against the CPU on lane 0 under TRAIN_TOL (sweep_parity, at
    B = WIDE_PARITY_BATCH), and 3 counted steps at the config's B=64 and
    dropout (remat: each forward walk
    twice a step, each adjoint once); then MMS_GRU_FOLD_GROUP=3 at H=BIG_H
    (5 lanes of G*H = 768: the streamed walk) against ungrouped for 3 steps
    under TRAIN_TOL. Returns the counted launches."""
    argv = ["--set", f"data_path={data}", "--set", f"model.gru_hidden_size={WIDE_H}"]
    cfg = cli.load_config(cli.build_parser().parse_args(argv))
    variables = random_variables(cfg, 16)
    x = np.random.default_rng(16).standard_normal((70, len(cfg.channels_to_use), WINDOW_T))
    x = x.astype(np.float32)
    card = Predictor(cfg, variables, device="cuda")
    gru_cuda.reset_launch_counts()
    # --- the main path: everything between reset and read is counted ---
    probs = card.predict_windows(x)
    counts = gru_cuda.launch_counts()
    # --------------------------------------------------------------------
    want = dict.fromkeys(KERNELS, 0)
    want["gru_fwd_fb"], want["gru_fwd"] = 2, 2   # 2 padded batches: layer 0, the pruned layer
    if counts != want:
        raise AssertionError(f"Predictor H={WIDE_H}: launches {counts}, expected {want}")
    cpu = Predictor(cfg, variables, device="cpu").predict_windows(x)
    err = _check_probs(probs, cpu, len(x), PROB_ATOL["float32"], f"Predictor H={WIDE_H}")
    print(f"16c Predictor H={WIDE_H}: 70 windows, card vs CPU max|d| {err:.3e}, "
          f"launches {counts}")
    total = dict(counts)

    staged = root / "wide_staged"
    staged.mkdir(parents=True)
    corpus = stage_corpus(cfg, staged)
    fb = build_fold_batch(corpus, list(cfg.subjects), cfg.val_fraction, cfg.seed)
    folds = len(fb.test_subjects)
    small = dataclasses.replace(cfg, trainer=dataclasses.replace(
        cfg.trainer, batch_size=WIDE_PARITY_BATCH))
    sweep_parity(small, corpus, fb, root, TRAIN_TOL["float32"],
                 f"16c sweep H={WIDE_H} B={WIDE_PARITY_BATCH}", cpu_folds=WIDE_CPU_FOLDS)
    seeds, rngs = fold_streams(cfg.seed, folds)
    sweep = FoldSweep(corpus, fb, cfg, "cuda", init_seeds=seeds)
    idx, w = sweep.to_device(sweep.train_grid(rngs))
    t0 = time.perf_counter()
    gru_cuda.reset_launch_counts()
    # --- the main path: everything between reset and read is counted ---
    losses = [sweep.train_step(idx[:, s], w[:, s])[0] for s in range(3)]
    torch.cuda.synchronize()
    counts = gru_cuda.launch_counts()
    # --------------------------------------------------------------------
    wall = time.perf_counter() - t0
    fwd, bwd = fold_walks(cfg.model)
    twice = 2 if cfg.trainer.remat else 1
    want = {k: 3 * (twice * fwd[k] + bwd[k]) for k in KERNELS}
    if counts != want or not all(torch.isfinite(v).all() for v in losses):
        raise AssertionError(f"sweep H={WIDE_H}: launches {counts}, expected {want}; "
                             f"losses {losses}")
    print(f"16c sweep H={WIDE_H} f32 F={folds}: 3 steps in {wall:.2f} s "
          f"({wall / 3 * 1e3:.1f} ms a step), launches {counts} (remat {cfg.trainer.remat})")
    total = {k: total[k] + counts[k] for k in KERNELS}
    del sweep, idx, w
    torch.cuda.empty_cache()

    gargv = ["--set", f"data_path={data}", "--set", f"model.gru_hidden_size={BIG_H}",
             "--set", "model.dropout=0.0"]
    gcfg = cli.load_config(cli.build_parser().parse_args(gargv))
    runs = {}
    for grouped in (False, True):
        seeds, rngs = fold_streams(gcfg.seed, folds)
        with fold_group(FOLD_GROUP if grouped else None), walk_shapes([]) as seen:
            sweep = FoldSweep(corpus, fb, gcfg, "cuda", init_seeds=seeds)
            idx, w = sweep.to_device(sweep.train_grid(rngs))
            gl = [sweep.train_step(idx[:, s], w[:, s])[0].cpu().tolist() for s in range(3)]
        runs[grouped] = (sweep.model, [v for row in gl for v in row], seen)
        del sweep
    (ref, ref_losses, seen_u), (grp, grp_losses, seen_g) = runs[False], runs[True]
    width = FOLD_GROUP * BIG_H
    if {(lanes, hid) for _, lanes, hid in seen_g} != {(folds // FOLD_GROUP, width)} or (
            not gru_cuda.walk_streamed(width, 4)):
        raise AssertionError(f"grouped H={BIG_H}: walks {sorted(set(seen_g))}")
    loss_err, worst, share, ok = compare_steps(grp, grp_losses, ref.cpu(), ref_losses,
                                               TRAIN_TOL["float32"], steps=3)
    summary = (f"losses max rel|d| {loss_err:.3e}, parameters max|d| {worst:.3e}, "
               f"{share:.4%} beyond {TRAIN_TOL['float32']['elem']}")
    if not ok:
        raise AssertionError(f"grouped H={BIG_H}: beyond TRAIN_TOL of ungrouped: {summary}")
    plan = gru_cuda.walk_plan(SERVE_B, folds // FOLD_GROUP, width, 4)["instantiation"]
    print(f"16c grouped f32 H={BIG_H}, G={FOLD_GROUP}: {len(seen_g)} walks of "
          f"{folds // FOLD_GROUP} lanes at H'={width} ({plan}) against {len(seen_u)} of "
          f"{folds} at H={BIG_H}, first 3 sweep steps: {summary}")
    del runs, ref, grp
    torch.cuda.empty_cache()
    return total


def engine_phase(data: Path) -> None:
    """16d: the host window engine. native.available() is true; phase 7's
    pack_corpus (cache off) goes through the engine's fused pack, once a
    subject; the pack against the NumPy path (max abs difference, labels and
    masks equal); pack seconds, engine against NumPy."""
    from multimodalsignal_tpu_torch import native

    if not native.available():
        raise AssertionError("the host window engine did not build on this host")
    cfg = cli.load_config(cli.build_parser().parse_args(["--set", f"data_path={data}"]))
    names = read_channel_names(data)
    args = (data, list(cfg.subjects), list(cfg.channels_to_use), names,
            cfg.classification_mode, cfg.normalization)
    native.reset_call_counts()
    t0 = time.perf_counter()
    eng = pack_corpus(*args, cache=False)
    eng_s = time.perf_counter() - t0
    calls = native.call_counts()
    if calls["pack_subject_f32"] != len(eng.subjects):
        raise AssertionError(f"engine: {calls} for {len(eng.subjects)} subjects")
    available = native.available
    native.available = lambda: False
    try:
        t0 = time.perf_counter()
        plain = pack_corpus(*args, cache=False)
        plain_s = time.perf_counter() - t0
    finally:
        native.available = available
    if not (np.array_equal(eng.y, plain.y) and np.array_equal(eng.mask, plain.mask)):
        raise AssertionError("engine: labels or masks differ from the NumPy path")
    diff = float(np.abs(eng.x - plain.x).max())
    if diff > 2e-5 * max(1.0, float(np.abs(plain.x).max())):
        raise AssertionError(f"engine: the pack is {diff:.3e} from the NumPy path")
    print(f"16d engine: built with {native.build_flags() or 'a library an earlier process built'}"
          f"; pack_corpus of {len(eng.subjects)} subjects x {eng.x.shape[1]} windows x "
          f"{eng.x.shape[2]} channels x {eng.x.shape[3]}: engine {eng_s:.3f} s "
          f"({calls['pack_subject_f32']} fused packs), NumPy {plain_s:.3f} s; max|engine - "
          f"NumPy| {diff:.3e}, labels and masks equal")


def remat_step(corpus, fb, cfg, what: str, seeds=None) -> None:
    """Step ms (median of 3 blocks of 1 step) and peak MiB of one step of
    a sweep over fb, trainer.remat off and on, in the order off, on, on,
    off."""
    seeds = seeds or (cfg.seed,)
    out = {}
    for remat in (False, True, True, False):
        init, rngs = seed_group_streams(seeds, fb.train_pool.shape[0])
        c = dataclasses.replace(cfg, trainer=dataclasses.replace(cfg.trainer, remat=remat))
        sweep = FoldSweep(corpus, fb, c, "cuda", init_seeds=init, dropout_seeds=seeds)
        idx, w = sweep.to_device(sweep.train_grid(rngs))
        ms = median_ms(lambda: sweep.train_step(idx[:, 0], w[:, 0]), per_block=1, blocks=3,
                       warmup=1)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        sweep.train_step(idx[:, 0], w[:, 0])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        out.setdefault(remat, []).append((ms, peak, held))
        del sweep, idx, w
        torch.cuda.empty_cache()
    text = "; ".join(
        f"remat {'on' if r else 'off'}: step " + " / ".join(f"{ms:.3f}" for ms, _, _ in v)
        + f" ms, peak {v[0][1] / 2**20:.1f} MiB ({v[0][2] / 2**20:.1f} held before)"
        for r, v in out.items())
    print(f"16e {what}: {text}")


def remat_phase(data: Path, root: Path) -> None:
    """16e: trainer.remat. The f32 and bf16 sweep at F=15, B=64 (phase 7's
    data, the config's dropout): 3 steps with remat on against off under
    TRAIN_TOL (the max difference, and whether bitwise), with exact launches
    in both modes (on: each forward walk twice a step); then step ms and
    peak MiB off and on at 15 lanes (H = 64 and 256) and at 60 lanes (4
    seeds, H = 64)."""
    t0 = time.perf_counter()
    base = cli.load_config(cli.build_parser().parse_args(["--set", f"data_path={data}"]))
    staged = root / "remat_staged"
    staged.mkdir(parents=True)
    corpus = stage_corpus(base, staged)
    fb = build_fold_batch(corpus, list(base.subjects), base.val_fraction, base.seed)
    folds = len(fb.test_subjects)
    fwd, bwd = fold_walks(base.model)
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, model=dataclasses.replace(base.model, dtype=dtype))
        runs = {}
        for remat in (False, True):
            seeds, rngs = fold_streams(cfg.seed, folds)   # the same weights and grid
            c = dataclasses.replace(cfg, trainer=dataclasses.replace(cfg.trainer, remat=remat))
            sweep = FoldSweep(corpus, fb, c, "cuda", init_seeds=seeds)
            idx, w = sweep.to_device(sweep.train_grid(rngs))
            gru_cuda.reset_launch_counts()
            losses = [sweep.train_step(idx[:, s], w[:, s])[0].cpu().tolist() for s in range(3)]
            counts = gru_cuda.launch_counts()
            want = {k: 3 * ((2 if remat else 1) * fwd[k] + bwd[k]) for k in KERNELS}
            if counts != want:
                raise AssertionError(f"remat {remat} {dtype}: launches {counts}, expected {want}")
            runs[remat] = (sweep.model, [v for row in losses for v in row], counts)
            del sweep, idx, w
        (off, off_losses, off_counts), (on, on_losses, on_counts) = runs[False], runs[True]
        bitwise = off_losses == on_losses and all(
            torch.equal(a, b) for a, b in zip(on.parameters(), off.parameters()))
        loss_err, worst, share, ok = compare_steps(on, on_losses, off.cpu(), off_losses,
                                                   TRAIN_TOL[dtype], steps=3)
        summary = (f"losses max rel|d| {loss_err:.3e}, parameters max|d| {worst:.3e}, "
                   f"{share:.4%} beyond {TRAIN_TOL[dtype]['elem']}")
        if not ok:
            raise AssertionError(f"remat {dtype}: on vs off beyond TRAIN_TOL: {summary}")
        print(f"16e remat {dtype} F={folds}: 3 steps at dropout {cfg.model.dropout}, on vs off "
              f"{'bitwise equal' if bitwise else 'not bitwise'}: {summary}; launches off "
              f"{off_counts}, on {on_counts}")
        del runs, on, off
        torch.cuda.empty_cache()
    for h in (SERVE_H, BIG_H):
        cfg = dataclasses.replace(base, model=dataclasses.replace(base.model, gru_hidden_size=h))
        remat_step(corpus, fb, cfg, f"float32 F={folds} H={h}")
    rfb = replicate_fold_batch(fb, len(SEEDS))
    remat_step(corpus, rfb, base, f"float32 F={len(SEEDS) * folds} ({len(SEEDS)} seeds) "
               f"H={SERVE_H}", seeds=SEEDS)
    print(f"16e: {time.perf_counter() - t0:.1f} s")


def phase16(root: Path, data: Path) -> dict[str, int]:
    """Phase 16 (module docstring): 16a the grid and streamed walks' plans
    and the six entries against their plain versions past the cluster
    walk's limit, 16b their times at H = 1024 and the adjoint's
    split, 16c a Predictor and the sweep at H = 512 and fold grouping at
    G*H = 768, 16d the host window engine, 16e trainer.remat. Returns 16c's
    counted launches (the main path of this phase)."""
    t_phase = time.perf_counter()
    root.mkdir()
    marks = [time.perf_counter()]
    stream_formulas()
    stream_walks_phase()
    marks.append(time.perf_counter())
    stream_timings()
    marks.append(time.perf_counter())
    wide = wide_sweep_phase(data, root)
    marks.append(time.perf_counter())
    engine_phase(data)
    marks.append(time.perf_counter())
    remat_phase(data, root)
    marks.append(time.perf_counter())
    split = ", ".join(f"16{k} {b - a:.1f} s" for k, a, b in zip("abcde", marks, marks[1:]))
    print(f"phase 16: {time.perf_counter() - t_phase:.1f} s ({split})")
    return wide


# ---------------------------------------------------------------------------
# Phase 17: the card's CI (gpu_ci: the CUDA kernel tier, the bench, the gate)
# and the bench's captured train step
# ---------------------------------------------------------------------------

CI_BENCH_STEPS = 100
BENCH_WARMUP = 10   # bench.py's --warmup default
# One single-fold train step of the default model under pallas_db (both
# directions of layer 0 as two lanes, the pruned layer 1's forward walk).
ONE_STEP_LAUNCHES = {"gru_fwd": 1, "gru_fwd_fb": 1, "gru_bwd": 1, "gru_bwd_fb": 1,
                     "gru_bifwd": 0, "gru_bibwd": 0}
CAPTURE_WARMUP = 2
PARITY_STEPS = 3
RESULT_KEYS = {"metric", "value", "unit", "vs_baseline"}
BENCH_LINE = re.compile(r"bench: .*, captured CUDA graph, ([\d.]+) ms a step; "
                        r"launches per captured step (\{.*\})")


def gpu_ci_phase(root: Path) -> tuple[dict, float]:
    """17a: `python -m multimodalsignal_tpu_torch.gpu_ci --baseline <new
    file> -- --steps 100` in a subprocess: exit 0, the kernel tier's pass
    count with nothing failed or skipped, the bench's last line with
    bench.py's four keys, the launches per captured step it reports equal
    to one eager step's, the pin created from it. Returns (the bench's
    result, its ms a step)."""
    pin = root / "gpu_bench_baseline.json"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "multimodalsignal_tpu_torch.gpu_ci", "--baseline", str(pin),
         "--", "--steps", str(CI_BENCH_STEPS)],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"gpu_ci exited {proc.returncode}:\n{proc.stdout[-4000:]}\n"
                             f"{proc.stderr[-4000:]}")
    tier = re.search(r"(\d+) passed[^\n]*in ([\d.]+)s", proc.stdout)
    if tier is None or re.search(r"\d+ (failed|skipped|error)", proc.stdout):
        raise AssertionError(f"gpu_ci: the kernel tier's summary is not all passed:\n"
                             f"{proc.stdout[-4000:]}")
    lines = [line for line in proc.stdout.splitlines() if line.startswith("{")]
    result = json.loads(lines[-1])
    if set(result) != RESULT_KEYS or not result["value"] > 0:
        raise AssertionError(f"gpu_ci: the bench's line is not bench.py's: {result}")
    if json.loads(pin.read_text())["steps_per_sec"] != result["value"]:
        raise AssertionError("gpu_ci: the baseline it created is not the bench's value")
    bench_line = BENCH_LINE.search(proc.stdout)
    if bench_line is None:
        raise AssertionError(f"gpu_ci: no bench line with its launches:\n{proc.stdout[-4000:]}")
    launches = ast.literal_eval(bench_line.group(2))
    if launches != {k: n for k, n in ONE_STEP_LAUNCHES.items() if n}:
        raise AssertionError(f"gpu_ci: the bench's captured step launched {launches}, "
                             f"expected {ONE_STEP_LAUNCHES}")
    print(f"gpu_ci: exit 0 in {seconds:.1f} s; kernel tier {tier.group(1)} passed, 0 failed, "
          f"in {tier.group(2)} s; {bench_line.group(0)}")
    print(f"gpu_ci: {json.dumps(result)}")
    return result, float(bench_line.group(1))


def gate_phase(result: dict, root: Path) -> None:
    """17e: the gate against pins of 10x and 0.5x the measured value: 2, then
    0, whatever the run's noise; against a pin of another metric: 1, no
    verdict."""
    for factor, metric, want in ((10.0, result["metric"], 2), (0.5, result["metric"], 0),
                                 (0.5, "another dtype's metric", 1)):
        pin = root / f"pin_{factor}_{want}.json"
        pin.write_text(json.dumps({"metric": metric, "tolerance": 0.05,
                                   "steps_per_sec": result["value"] * factor, "note": "test"}))
        rc = gpu_ci.check_baseline(result, pin, update=False)
        if rc != want:
            raise AssertionError(f"gpu_ci's gate at a pin of {factor}x ({metric}): exit {rc}, "
                                 f"want {want}")


def bench_setup(dtype: str, dropout: float, capturable: bool, variables: dict):
    """The bench's model (pallas_db) at `dropout` with `variables`' weights,
    Adam (capturable or not), the fixed batch and a seeded generator: (model,
    optimizer, generator, make_train_step's step)."""
    model = bench.bench_model(3, "pallas_db", dtype, dropout=dropout)
    load_jax_variables(model, variables["params"], variables["batch_stats"])
    model.cuda()
    opt = make_optimizer(model.parameters(), LR, 1e-4)
    if capturable:
        bench.make_capturable(opt)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x, y, w = bench.fixed_batch(BATCH, 3, WINDOW_T, "cuda")
    return model, opt, gen, bench.make_train_step(model, opt, x, y, w, gen)


def restore(model, opt, state: dict) -> None:
    """Put the weights and batch statistics back in place (the graph holds
    their addresses) and Adam's moments and step counts back to zero."""
    model.load_state_dict(state)
    with torch.no_grad():
        for group in opt.state.values():
            for t in group.values():
                t.zero_()


def captured_vs_eager(dtype: str, variables: dict):
    """17b-c. From the same weights at dropout 0, PARITY_STEPS replays of the
    captured step (after its warm-up and capture, the weights and Adam's
    state restored) against as many eager steps (Adam as make_optimizer
    returns it), under TRAIN_TOL; launches in the captured step equal one
    eager step's (ONE_STEP_LAUNCHES). A replay from the restored state
    repeats the first loss bitwise at dropout 0; at dropout 0.5 two replays
    from the same state differ (the generator registered with the graph
    draws new masks). Returns that dropout-0.5 graph (the bench's step)
    and the step it captured, which keeps alive the tensors it reads."""
    eager, _, _, step = bench_setup(dtype, 0.0, False, variables)
    gru_cuda.reset_launch_counts()
    want = [step().item()]
    eager_launches = gru_cuda.launch_counts()
    want += [step().item() for _ in range(PARITY_STEPS - 1)]
    model, opt, gen, step = bench_setup(dtype, 0.0, True, variables)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    graph, loss, launches = bench.capture(step, CAPTURE_WARMUP, gen)
    if launches != eager_launches or launches != ONE_STEP_LAUNCHES:
        raise AssertionError(f"captured step {dtype}: launches {launches}, one eager step "
                             f"{eager_launches}, expected {ONE_STEP_LAUNCHES}")
    restore(model, opt, start)
    got = []
    for _ in range(PARITY_STEPS):
        graph.replay()
        got.append(loss.item())
    tol = TRAIN_TOL[dtype]
    loss_err, worst, share, ok = compare_steps(model, got, eager.cpu(), want, tol)
    summary = (f"losses max rel|d| {loss_err:.3e}, parameters max|d| {worst:.3e}, "
               f"{share:.4%} beyond {tol['elem']}")
    if not ok:
        raise AssertionError(f"captured step {dtype}: replays vs eager beyond TRAIN_TOL: "
                             f"{summary}; losses {got} vs {want}")
    restore(model, opt, start)
    graph.replay()
    if loss.item() != got[0]:
        raise AssertionError(f"captured step {dtype}: a replay from the restored state gave "
                             f"{loss.item()}, the first {got[0]}")
    print(f"captured step {dtype}, dropout 0: {PARITY_STEPS} replays vs eager steps, losses "
          + ", ".join(f"{a:.6f}/{b:.6f}" for a, b in zip(got, want))
          + f"; {summary}; launches in the graph {launches} = one eager step's; a replay "
          "from the restored state repeats the first loss bitwise")
    model, opt, gen, step = bench_setup(dtype, ModelConfig.dropout, True, variables)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    graph, loss, _ = bench.capture(step, CAPTURE_WARMUP, gen)
    draws = []
    for _ in range(2):
        restore(model, opt, start)
        graph.replay()
        draws.append(loss.item())
    if draws[0] == draws[1] or not all(math.isfinite(v) for v in draws):
        raise AssertionError(f"captured step {dtype}, dropout {ModelConfig.dropout}: two "
                             f"replays from one state gave losses {draws}: the masks did not "
                             "change")
    print(f"captured step {dtype}, dropout {ModelConfig.dropout}: two replays from one state, "
          f"losses {draws[0]:.6f} and {draws[1]:.6f}: new masks each replay")
    return graph, step


def bench_f32() -> tuple[dict, dict[str, int]]:
    """17d's main path: the bench's float32 captured step (bench.bench_torch:
    BENCH_WARMUP eager steps, the capture, 3 reps of CI_BENCH_STEPS replays),
    counted. The counters see the warm-up steps and the capture, never a
    replay: BENCH_WARMUP + 1 launches of each kernel of one step. Returns
    (bench_torch's result, the counts)."""
    gru_cuda.reset_launch_counts()
    # --- the main path: the bench's captured step ---
    out = bench.bench_torch(BATCH, 3, WINDOW_T, CI_BENCH_STEPS, BENCH_WARMUP, "pallas_db",
                            "float32")
    launches = gru_cuda.launch_counts()
    # -----------------------------------------------
    want = {k: (BENCH_WARMUP + 1) * n for k, n in ONE_STEP_LAUNCHES.items()}
    if out["launches"] != ONE_STEP_LAUNCHES or launches != want:
        raise AssertionError(f"bench float32: launches {launches}, expected {want}; per "
                             f"captured step {out['launches']}, expected {ONE_STEP_LAUNCHES}")
    return out, launches


def step_timings(dtype: str, variables: dict, captured_ms: float, graph,
                 where: str) -> None:
    """17d. The bench's captured step's ms (`captured_ms`, measured `where`)
    beside the eager step's from the same make_train_step (CUDA events
    around blocks of 5), both at the config's dropout; traces of `graph`'s
    replays and of eager steps."""
    _, _, _, eager_step = bench_setup(dtype, ModelConfig.dropout, False, variables)
    eager_ms = median_ms(eager_step, per_block=5)
    print(f"bench step {dtype} (B={BATCH}, C=3, T={WINDOW_T}, dropout {ModelConfig.dropout}): "
          f"captured {captured_ms:.4f} ms ({1e3 / captured_ms:.3f} steps/s, {where}, "
          f"{CI_BENCH_STEPS} replays x 3), eager {eager_ms:.4f} ms ({1e3 / eager_ms:.3f} "
          f"steps/s), eager / captured {eager_ms / captured_ms:.2f}x")
    trace(graph.replay, f"captured {dtype} step")
    trace(eager_step, f"eager {dtype} step")


def phase17(root: Path) -> dict[str, int]:
    """Phase 17 (module docstring): 17a gpu_ci in a subprocess, 17b-c the
    captured step against the eager one and its dropout masks, f32 and
    bf16, 17d the captured and eager step times, 17e the gate's mechanics.
    Returns 17d's float32 counted launches (the main path of this phase)."""
    t_phase = time.perf_counter()
    root.mkdir()
    marks = [time.perf_counter()]
    result, ci_ms = gpu_ci_phase(root)
    marks.append(time.perf_counter())
    cfg = ExperimentConfig(model=ModelConfig(gru_impl="pallas_db"))
    variables = random_variables(cfg, seed=0)
    captured_vs_eager("float32", variables)
    bf16_graph, bf16_step = captured_vs_eager("bfloat16", variables)
    marks.append(time.perf_counter())
    out, launches = bench_f32()   # out holds the graph and the tensors it reads
    step_timings("float32", variables, out["ms"], out["graph"], "bench_torch here")
    # bfloat16's captured step is 17a's bench (the same shape and replays);
    # its trace is 17c's graph of the same step.
    step_timings("bfloat16", variables, ci_ms, bf16_graph, "gpu_ci's bench")
    del bf16_graph, bf16_step, out
    marks.append(time.perf_counter())
    gate_phase(result, root)
    marks.append(time.perf_counter())
    split = ", ".join(f"17{k} {b - a:.1f} s" for k, a, b in zip(("a", "b-c", "d", "e"),
                                                               marks, marks[1:]))
    print(f"phase 17: {time.perf_counter() - t_phase:.1f} s ({split})")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke test "
              "needs a CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["jobs"]:
        return rank_worker(sys.argv[2])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card()
    laps = [("", time.perf_counter())]
    lap = lambda what: laps.append((what, time.perf_counter()))  # noqa: E731
    build_phase()
    lap("build")
    kernels = [
        kernel_phase("gru_fwd", gru_cuda.gru_forward, gru_cuda.gru_forward_plain,
                     fb=False, source_line="multimodalsignal_tpu/ops/gru_pallas.py:77"),
        kernel_phase("gru_fwd_fb", gru_cuda.gru_forward_fb,
                     gru_cuda.gru_forward_fb_plain, fb=True,
                     source_line="multimodalsignal_tpu/ops/gru_pallas.py:371"),
        bwd_kernel_phase("gru_bwd", gru_cuda.gru_backward, gru_cuda.gru_backward_plain,
                         fb=False, source_line="multimodalsignal_tpu/ops/gru_pallas.py:174"),
        bwd_kernel_phase("gru_bwd_fb", gru_cuda.gru_backward_fb,
                         gru_cuda.gru_backward_fb_plain, fb=True,
                         source_line="multimodalsignal_tpu/ops/gru_pallas.py:460"),
        fused_kernel_phase("gru_bifwd", gru_cuda.gru_bifwd, gru_cuda.gru_bifwd_plain,
                           adjoint=False,
                           source_line="multimodalsignal_tpu/ops/gru_pallas.py:874"),
        fused_kernel_phase("gru_bibwd", gru_cuda.gru_bibwd, gru_cuda.gru_bibwd_plain,
                           adjoint=True,
                           source_line="multimodalsignal_tpu/ops/gru_pallas.py:945"),
    ]
    lap("kernels")
    passes_phase()
    lap("passes")
    walk_sweep()
    lap("walk sweep")
    m2_shape_timings()
    lap("M2 shapes")
    with tempfile.TemporaryDirectory() as tmp:
        pkl = Path(tmp) / "S99.pkl"
        write_recording(pkl, seconds=300, seed=2)
        serve_launches = serving_phase("float32", pkl)
        serving_phase("bfloat16", pkl)
        lap("serving")
        train_launches = training_phase("float32", Path(tmp))
        training_phase("bfloat16", Path(tmp))
        lap("training")
        loso_data = write_loso_data(Path(tmp) / "loso_data", seed=4)
        loso_launches, loso_run = loso_phase("float32", loso_data, Path(tmp))
        loso_phase("bfloat16", loso_data, Path(tmp))
        lap("LOSO")
        data = write_loso_data(Path(tmp) / "sweep_data", seed=8, subjects=ALL_SUBJECTS)
        with capture_sweeps(fold_sweep) as seen:
            sweep_launches, sweep_run = sweep_phase("float32", ["--set", f"data_path={data}"],
                                                    Path(tmp))
        _, bf16_run = sweep_phase("bfloat16", ["--set", f"data_path={data}"], Path(tmp))
        lap("sweep")
        ensemble_phase(sweep_run)
        lap("ensemble")
        print(f"phases 1-8: {laps[-1][1] - laps[0][1]:.1f} s ("
              + ", ".join(f"{w} {t - laps[i][1]:.1f} s" for i, (w, t) in enumerate(laps[1:]))
              + ")")
        wesad, hybrid_run = phase9(Path(tmp) / "phase9")
        hier_run, ablation_run = phase10(Path(tmp) / "phase10", wesad, loso_data, data,
                                         seen[0])
        phase11(Path(tmp) / "phase11", sweep_run, bf16_run, hybrid_run, hier_run, wesad)
        phase12(Path(tmp) / "phase12", data, loso_data, sweep_run,
                ablation_run / "fusion4__cnn_gru_attention")
        fused_launches = phase13(Path(tmp) / "phase13", data, loso_run, wesad)
        split_launches = phase14(Path(tmp) / "phase14", data)
        large_launches = phase15(Path(tmp) / "phase15", data)
        wide_launches = phase16(Path(tmp) / "phase16", data)
        ci_launches = phase17(Path(tmp) / "phase17")
    # launches: gru_fwd's on the float32 serving path, gru_bwd's on the
    # float32 training path, the fb pair's on the float32 sweep (the CLI's
    # default execution), the fused sweep, phase 14's two-rank runs and
    # phase 15's sweeps at H=256 and grouped, the fused pair's on the
    # float32 serial LOSO path, the fused sweep and phase 14's fused
    # two-rank run, and the four of the bench's float32 run (phase 17: its
    # warm-up steps and the capture) (each read right after its own counted
    # run, all checked above).
    paths = {"gru_fwd": (serve_launches, ci_launches),
             "gru_bwd": (train_launches, ci_launches),
             "gru_fwd_fb": (sweep_launches, fused_launches, split_launches, large_launches,
                            wide_launches, ci_launches),
             "gru_bwd_fb": (sweep_launches, fused_launches, split_launches, large_launches,
                            wide_launches, ci_launches),
             "gru_bifwd": (loso_launches, fused_launches, split_launches),
             "gru_bibwd": (loso_launches, fused_launches, split_launches)}
    for k in kernels:
        k["launches"] = sum(path[k["name"]] for path in paths[k["name"]])
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} was not launched on its main path")
    print(f"chip_smoke: {time.perf_counter() - laps[0][1]:.1f} s from the build to the end")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
