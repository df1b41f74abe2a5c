#!/usr/bin/env python3
"""Smoke run of emloco_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each printed as one JSON line with its elapsed seconds:
  1. build    — nvcc builds the kernels' library into build/ (plain C
                interface, loaded with ctypes); ptxas's lines (registers,
                static shared memory, spills per kernel), and the launch
                shape and dynamic shared memory of the five kernels that
                keep an env's matrix in shared memory (factor, resolve,
                fused solve, batch-major resolve, dense solve) and of
                gram_diag (with its CTAs an SM, from the occupancy query)
  2. card     — the card's name and power limit from nvidia-smi
  3. kernels  — both block-arrow Cholesky kernels against their plain
                PyTorch versions on a real assembled LHS at 4,096 envs, on
                a random block-arrow SPD batch with a clamped and a
                near-singular pivot, on a ragged one of 4,093 envs (not a
                multiple of a block's envs) and on a dense SPD batch (every
                entry nonzero: the factor copies the entries outside the
                pattern through, as its plain version does); the factor
                and the resolve must be bit-equal; kernel, plain and
                library times
  4. main     — the rollout step at the bench configuration (4,096 envs,
                sensor_res 32, 15 AMP steps, episode length 168): observe →
                normalize → actor → env.step for a few control steps, with
                the kernels' launch counts read around it
  5. reference — one step at 8 envs on the card against the same step on
                the CPU (the port's plain path)
  6. solver_kernels — the fused block-arrow solve, the batch-major resolve,
                the dense Cholesky solve and the env-last relayout against
                their plain versions on the same four inputs (the
                relayout also on the (N, 80, 75) staging shape cropped to
                75), the fused solve, the batch-major resolve and the dense
                solve bit for bit; the fused solve against factor + resolve
                and the batch-major resolve against the env-last one, bit
                for bit
  7. solver_times — those four kernels' times, their plain versions' and a
                PyTorch call's that computes the same function
  8. gram_kernel — the weighted Gram kernel against its plain version at
                4,096 envs, bit for bit, on the two-operand rows of the reset
                state (bf16 and, with `rows_bf16=False`, float32), on random
                rows, and on the (N, 80, 75) staging shape then through
                to_env_last cropped to 75, the engine's env-last composition
  9. gram_times — its time, its plain version's and a PyTorch call's that
                computes the same function (and a bf16 `bmm` with float32
                output), on the bf16 rows and on the float32 rows, each
                with its bound, its time's share of it and the CUDA cores'
                floor (the multiply-adds it sums at the float32 peak)
 10. paths    — each other configuration of the engine at the bench
                configuration: the solver paths (implicit substeps, one
                substep, dense solver, batch-major TGS, batch-major
                implicit), the `gram_kernel=True` paths (TGS env-last and
                batch-major, implicit with the block-arrow and the dense
                solver) and the two-operand Gram (`sqrt_gram=False`); one
                warm-up and 2 control steps each, launch counts read around
                the 2 steps
 11. train    — the PPO + AMP training epoch at the bench's training
                configuration (rollout.build_train_bench: 1,600 envs,
                horizon 32, 20 minibatches × 6 mini-epochs, AMP batch 512,
                the default network and engine): one warm-up epoch through
                `train_epoch`, then one timed epoch run part by part
                (rollout, prepare: GAE + norms + replay + demos, update) with
                a synchronize after each and the launch counts read around
                it (factor 32, resolve 64, every other kernel 0; the
                optimizer's kernel one step a minibatch, 120); every
                metric and parameter finite, no nonfinite gradient, the
                parameters moved, the replay ring filled by both epochs, the
                discriminator reward below its cap; then one more control
                step of the trained policy with the LHS and both
                right-hand sides it passes to the factor and the resolves
                recorded, and both kernels run again on them bit-equal to
                their plain versions (outside the counted epoch)
 12. train_reference — the timed epoch's first minibatch (2,560 rows, its
                demo and replay blocks and dropout masks, the parameters and
                optimizer state before the update) through one update on
                the card and on the CPU, in float64: every loss term within
                1e-4 of its magnitude, each gradient leaf within 1e-4 of its
                largest |g|, the card's step within 1e-3 × lr of the CPU
                optimizer's step on the card's gradients, and each update
                within 1e-3 × lr of the CPU's where the gradient stands
                clear of its tolerance (tests/test_torch_train.py); in
                float32 its loss terms within 1e-4 and its gradients and
                updates printed beside the ReLU decisions the devices take
                the other way (float32 gradients part at such kinks, as in
                21)
 13. value    — the LocoVal epoch at the bench's training configuration
                (rollout.build_value_bench: 1,600 envs, the synthetic
                real-path bank with half the real paths heading-inverted,
                the frozen PPO + AMP agent, ValuePoseNet with pose and
                velocity at 13 waypoints, ValueTrainConfig's defaults:
                horizon 32, step_to_pred 144): one warm-up `train_epoch`,
                then 5 timed epochs part by part (collect, update) with the
                launch counts read around them (factor 32, resolve 64 an
                epoch, every other kernel 0); every metric and valuenet
                parameter finite, the parameters moved, at least 1,600
                latched samples and every env latched at least once over
                the 5 epochs (steps 32-191), both inverted and plain
                episodes among the latched; then `evaluate` over 2 games:
                a finite mse in [0, 1] and its correlation; each epoch's
                collect and update seconds, env-steps/s, peak memory
 14. value_reference — the last timed epoch's samples (51,200 rows) and
                the valuenet state before its update through one update on
                the card and on the CPU: the loss within 1e-5 of its
                magnitude, each gradient leaf within 1e-5 of its largest
                |g|, the updated parameters within 1e-3 × lr_t per entry
                where the gradient stands clear of its tolerance, and the
                card's step within that of the CPU optimizer's step on the
                card's gradients on every entry (as train_reference; the
                largest difference over every entry is reported with its
                gradient); the EmLoco loss and its gradient
                with respect to 4,096 of the epoch's trajectories, card
                against CPU, within 1e-5
 15. plausibility — the entry points on the card: `train_value --epochs 1`
                writes a valuenet checkpoint to a temporary directory,
                `optimize_traj --batch-size 4096 --steps 200` reads it; the
                values finite, their mean after the steps not below the mean
                before, waypoint 0 bit-equal to the start; the seconds of
                the 200 steps; then optimize_trajectory on 64 trajectories
                for 20 steps on the card within 1e-4 of the CPU
 16. reference_implicit — one 8-env step on the card against the CPU for
                `tgs_step=False`, `batch_major_solver=True`,
                `gram_kernel=True` and `sqrt_gram=False`, each with the
                contacts whose `active` flag differs between the two
                devices at each call of the contact builder (every substep
                of the implicit step, the first of a TGS step) and their
                penetrations, and the joints whose PD error exp-map is zero
                on one device only at each substep (as in `reference`)
 17. probe_kernels — the Gram-layout probe's two tensor-core kernels,
                gram_dual and gram_dual_batched (blocks of 8 and 32 envs),
                against their plain version at 4,096 envs on the probe's
                seed-0 operands (M = 304) and on the reset state's bf16
                merged rows (M = 256), and on a small ragged case (M = 37):
                within 2^-13 of the sum of |products| per entry, the three
                outputs bit-equal, finite, each kernel launched; with the
                SHA-256 of each output's bytes, so that two trees' kernels
                can be compared by their smokes' probe_kernels lines
 18. probe_times — their times, their plain version's and a bf16 `bmm`'s
                with float32 output at the probe's shapes, each kernel's
                bound and its time's share of it; then `probe`:
                emloco_tpu_torch.scripts.gram_kernel_probe at full size
                (4,096 envs), its variant lines echoed under the phase
                name, with the kernels' launch counts read around it
 19. sensor_paths — the control step at 4,096 envs for each sensor variant
                of rollout.SENSOR_VARIANTS (the velocity map; groups of 128
                with the people stamped into it; the 450-point fan), one
                warm-up and 2 steps each with the launch counts read around
                them (factor 1, resolve 2 a step); then on a reset and
                stepped state of 8 envs the card's observe against the
                CPU's within one bf16 ulp of each block's magnitude, save
                the sensor points within 1e-4 m of a terrain cell edge or a
                footprint box edge (and an env's whole height channel when
                a point of its center patch is), which are printed and
                counted
 20. crowd_train — rollout.build_crowd_bench at 1,600 envs (groups of 100,
                the velocity map with the people stamped in, the crowd
                observation through the pointnet, the conv encoder over
                the 32×32×3 image): a warm-up epoch, then 1 timed epoch
                part by part with the launch counts read around it
                (factor 32, resolve 64); metrics and parameters finite,
                the discriminator reward below its cap and its loss above
                1e-3; peak memory
 21. crowd_reference — the first timed epoch's first minibatch of the crowd
                agent through one update on the card and on the CPU: in
                float64 with train_reference's tolerances (the conv and
                pointnet gradients held too), in float32 with its loss
                terms within 1e-4 and its gradients and updates printed
                beside the ReLU and max-pool decisions the devices take
                the other way (float32 gradients part at such kinks);
                then query_value_gradient on 64 envs of the crowd
                configuration, card against CPU (the CPU run takes the
                card's observation of the state), within 1e-5
 22. bf16_train — the training epoch with `hidden_bf16` at the bench's
                training configuration: warm-up, 1 timed epoch as in
                crowd_train; then every head on 2,560 of the epoch's rows
                on the card against the CPU within 2^-6 of its largest
                output
 23. perturbations — 32 control steps at 1,600 envs with obs and action
                noise, pushes and projectile hits every 8 steps,
                hard-negative sampling and episodes of 24 steps (launches
                32 / 64): each push's and
                hit's change of the root velocity equals the kick computed
                here from its draws, untouched envs unchanged; Σ
                motion_sampled equals the dones; after the refresh the
                weights sum to 1 within 1e-6 and the demo fetch draws its
                motions in their proportions; everything finite
 24. contact_paths — the control step at 4,096 envs under the engine's
                contact variants (CONTACT_PATHS: self-contact, the mesh
                colliders with the template's capsule-axis spheres and with
                spheres fit to the SMPL fixture, the 32-cell terrain
                window, self + mesh on implicit substeps, and gram_kernel
                with self, mesh and both): one warm-up and 2 control steps
                each, launch counts read around the 2 steps (with
                self-contact the dense solve, 2 a step: 6 of the pairs
                couple two limbs outside the block-arrow pattern), each
                with its env-steps/s, merged rows M and active self pairs;
                on the warm-up step of each gram variant the rows it passes
                to gram_diag are recorded, and
 25. contact_kernels — gram_diag against its plain version on those rows
                (M = 352, 480, 576), bit for bit, batch-major and staged,
                and its time at each M with its bound
 26. reference_contacts — one 8-env step on the card against the CPU for
                self_contact, mesh_contacts, terrain_patch=32 and
                gram_kernel + self_contact, from a pose with the left
                forearm folded into the torso (an interpenetrating self
                pair), with the contacts (ground and pair rows) whose
                `active` flag differs between the devices at each call of
                _contact_and_jacobians
 27. getup_train — the getup training configuration
                (rollout.build_getup_bench: 1,600 envs, TRAIN_AMP,
                self-contact and SMPL-fixture mesh colliders): the fall
                bank generated again and timed (75 control steps at 2
                substeps; finite, the median root between the terrain and
                the drop height, at least 90% of the envs on the ground),
                then a warm-up and a timed epoch
                part by part with both schedules applied (dense solve 64
                an epoch); finite, parameters moved, fall-bank resets and
                recovery counters seen
 28. hand_train — the hand task's training configuration
                (rollout.build_hand_bench): a warm-up and a timed epoch
                part by part (factor 32, resolve 64), obs_dim the terrain
                env's + 2, finite, parameters moved
 29. policy_checkpoint — one training epoch at 1,600 envs saved as a policy
                file (utils.checkpoint.save_policy) and read into a fresh
                agent: the deterministic action on the same observation,
                the parameters, the three norms and the Adam moments and
                count bit-equal; then `train_value --policy` for one epoch,
                finite, the policy's parameters loaded
 30. predictor_train — the jta preset at full width (nhid 128, 4 heads,
                dim_ff 1,024, 6 local + 3 global layers, 20 modes, dropout
                0.1, 453-token local sequences) on SyntheticScenes of 4
                people: a warm-up step, then 20 steps of batch 10 (one epoch
                of the CLI's defaults) with the EmLoco loss through a frozen
                ValuePoseNet; losses finite, parameters moved, the LocoVal
                parameters bit-equal, the value loss nonzero and its
                gradient at the heads nonzero; steps/s and ms a step; none
                of the engine's kernels launched (as in 31-33); the
                optimizer's kernel one step a step
 31. predictor_reference — one train step at full width, dropout on, the
                draws made on the CPU, on the card and on the CPU from the
                same state and batch: in float64 with train_reference's
                tolerances (the attention key biases' gradients, zero but
                for rounding, held to the largest |g| of any leaf); then in
                float32, the main path's step, with its loss terms held
                and its gradients and updates printed beside the count of
                FF pre-activations whose sign the devices take the other
                way (ReLU kinks, where float32 gradients part); eval-mode
                predict in float32 within 1e-4 of the largest |output|
 32. predictor_eval — evaluate_with_filter (LocoVal filter at 0.7) on the
                JTA fixture's windows, batch 10, 20 batches on the card,
                timed (scenes/s), the threshold sweep and the
                observation-length sweep; then the same calls on the card
                and on the CPU on 2 batches (1 for the length sweep) of the
                same windows at the same padding of 8 people: every metric
                within 1e-4 of its magnitude, a mode kept on one device
                only only within 1e-5 of the threshold (counted by
                threshold), and only at such a threshold its filtered
                minima excused and its kept_frac within two modes a flip
 33. predictor_paths — the jrdb preset (246-token local sequences) and the
                lstm preset: a warm-up and 2 train steps and one predict
                each, finite, steps/s
 34. eqmotion_train — the EqMotion baseline at full width, the compact
                model (EqMotionConfig(): past 8, future 12, hidden 64, 32
                channels, 4 layers, 20 modes, 4 categories) and the
                architecture-exact one (eth_full_config(): nf 64, 64
                channels, 4 layers, 20 modes, no agent tokens), each on
                synthetic ETH scenes of 10 × 4 agents with the EmLoco loss
                at weight 0.1 through a seeded ValuePoseNet(use_pose=False,
                use_vel=True): a warm-up step, then 20 steps (one epoch of
                the CLI's defaults); losses finite, parameters moved, the
                LocoVal parameters bit-equal, the value loss and its
                gradient at the heads nonzero, none of the engine's kernels
                launched (as in 35, 36 and 38); steps/s and ms a step
 35. eqmotion_reference — one train step of each architecture on the card
                and on the CPU from the same state and batch: in float64
                with train_reference's tolerances; in float32, the main
                path's step, its loss terms within 1e-4 and its gradients
                and updates printed beside the rows whose WTA winner
                differs and, for the full model, the reflection-gate
                products whose sign differs between the devices; predict in
                float32 within 1e-4 of the largest |output|
 36. eqmotion_eval — `evaluate` with the LocoVal filter at 0.7 on the ETH
                fixture's windows (4 agents), card against CPU within 1e-4,
                a mode kept on one device only only within 1e-5 of the
                threshold (counted); then `train_eqmotion --ethucy
                <fixture> --epochs 2 --valuenet <file>` on the card and its
                eqmotion.ckpt read back bit-equal
 37. eval_policy — `eval_policy --grid --games 1` at the bench's training
                configuration (1,600 envs): four conditions, a finite mse
                or no latched episode, factor 32 and resolve 64 launches in
                each condition's rollouts; then `rollout_with_rewards` for
                90 steps (the GIF's length) at env 0: frames finite, factor
                90 and resolve 180 launches, steps/s
 38. prediction_tools — collect_vis_data on the JTA fixture at the jta
                preset's full width, card against CPU within 1e-4;
                export_scene_dataset of 32 synthetic scenes read back
                equal; `tune_predictor --trials 2 --epochs 1 --batches 2` at
                the jta preset, both trials finite, and the command run
                again resumes after them
 39. cli_world — the system's entry point, `cli.run` (phases 39-44 run it
                through one helper, `run_cli`, with the launch counts read
                around each call): configs/pacer_terrain.yaml's world
                (1,600 envs, mixed 8 × 8 terrain of 8 m tiles, synthetic
                motions and bank) built by `_build_world` on the card and
                on the CPU, terrain, spawn table, bank and motion library
                bit-equal; then its first control step at 8 envs, card
                against CPU, under phase 5's gates
 40. cli_train_policy — `train-policy --config configs/pacer_terrain.yaml
                epochs=2 save_every=1` at full width: factor 64, resolve
                128; its checkpoint read back bit-equal; the jsonl row and
                the tb/ event file equal; then `--resume` one epoch:
                factor 32, resolve 64, policy_00000002.ckpt with the
                absolute epoch 2, bit-equal; each epoch's seconds (to a
                synchronize) and env-steps/s
 41. cli_commands — train-valuenet --policy and eval-policy --games 1
                (each factor 32, resolve 64), train-predictor and
                eval-predictor at configs/jta_predictor.yaml's width,
                optimize-traj, train-eqmotion, tune-predictor --trials 2
                (none of the engine's kernels) and visualize-pred (without
                matplotlib it must raise for it), once each at small epochs
                and batches, each writing what the JAX command writes
 42. cli_profile — `train-policy --profile epochs=1` at 256 envs and
                horizon 4: the trace holds the factor kernel's 4 and the
                resolve's 8 CUDA launches of the traced epoch
 43. viewer — a ViewerSession at 1,600 envs: 5 chunks of 4 steps (factor
                20, resolve 40), the controls, then the ViewerServer on
                port 0 through urllib (/status, POST /control, the sim loop
                advancing, /frame.png's error reply without matplotlib, a
                bad command refused); last_error must stay None
 44. native   — the C++ helpers built with g++ there, against the numpy
                versions: the pacer terrain's walkable mask bit-equal, its
                spawn table within 1 float32 ulp, a mesh's rasterization,
                the JTA fixture's scenes equal
 45. kinematics_variants — the SMPL forward (`kinematics.smpl.
                get_joints_verts`) for 1,600 bodies at SMPL's published
                sizes (6,890 vertices, 10 betas, 207 pose-blendshape
                features, 24 joints; the values from a seed: no model file
                is in the repository) on the card, its seconds, the first
                64 bodies against the CPU within 1e-5 of the largest |v|;
                `retarget_motion` onto a 14-joint skeleton, card against
                CPU within 1e-5; a BVH and a synthetic AMASS sequence
                (`bvh.load_bvh`, `curation.amass_to_motion`) filtered,
                flip-augmented and saved as a motion pickle, read by
                `load_reference_pkl` on the card and on the CPU (within
                1e-5 of each field's magnitude)
 46. mesh_reference — configs/pacer_terrain.yaml's world split over 2 ranks
                in one process (the step needs no collective): each rank's
                reset the rows of the one-rank reset, and one control step
                of the two ranks against the one-rank step within phase 5's
                2⁻⁸ (the sensor points within 1e-4 m of a cell edge
                excused and counted, as in sensor_paths); then the first
                minibatch of a one-rank epoch at 1,600
                envs taken by each rank (`minibatches` under the mesh): the
                ranks' loss terms and gradients summed against the one-rank
                update's within train_reference's tolerances, and the update
                from the summed gradients within 1e-3 × lr of the one-rank
                update
 47. cli_mesh — `train-policy --config configs/pacer_terrain.yaml --mesh 2
                epochs=2 save_every=1` (1,600 envs, 800 a rank, each rank a
                process on the card; gloo when the ranks outnumber the
                cards): each rank's backend and device map, seconds an
                epoch, factor 64 and resolve 128 launches; the ranks'
                parameters bit-equal to each other and to the last
                checkpoint (policy_00000001.ckpt, epoch 1); then `--resume`
                it for one epoch (factor 32, resolve 64 a rank,
                policy_00000002.ckpt at the absolute epoch 2, bit-equal);
                then `train-predictor --config configs/jta_predictor.yaml
                --mesh 2 --batches 8` (batch 10, 5 a rank), its best
                parameters bit-equal to its checkpoint, steps/s
 48. obs_options — the bench world at 4,096 envs with bodies built on the
                card from betas N(0, 0.3²) by `PedestrianTerrainEnv(…,
                betas=)` (bit-equal to build_body_params of them), 2
                control steps (factor 2, resolve 4); humanoid_obs_max,
                amp_obs, location_obs and group_obs (groups of 128) of the
                card's body state under each (root_height_obs, upright)
                pair against the same tensors on the CPU, within 1e-5 of
                the CPU's largest |value| (a group_obs row whose
                neighbours order the other way by a near tie, distances
                within 1e-6 m, excused and counted); to_mjcf of env 0's
                and env 4,095's bodies against those of the same betas
                built on the CPU: the same layout, numbers within 1e-4;
                the phase's seconds on a line of its own
 49. clip_adam — the optimizer's kernel (`learning/fused_adam.py`,
                csrc/clip_adam.cu) against its plain version on the card
                at the leaves of the bench's training network (29) and of
                configs/jta_predictor.yaml's TransMotion (162), from count
                5: bit-equal where the clip does not engage (constant and
                decayed rate, guard on and off); where it does, the plain
                step at a norm within NORM_ULP ulp of the plain version's
                own, bit for bit; two runs bit-equal; a planted NaN under
                the guard giving back the old state and count bit for bit;
                one count in fused_adam.LAUNCHES a step; its device ms
                (launches queued behind a sleep) and each pass's under
                torch.profiler, its host ms a step, the plain version's ms
                and, as a yardstick only, torch.optim.Adam(fused=True) on
                the same leaves (no clip), with the bytes bound (7 x 4
                bytes a parameter)
 50. loss_graph — the minibatch's loss and gradients as one CUDA graph
                (`AMPAgent._loss_and_grads`, utils/cuda_graph.py) on the
                sept and the sept_cnn agents at the bench's sizes (1,600
                envs, minibatches of 2,560 rows, AMP batch 1,280, dropout
                on): LOSS_GRAPH_CALLS `_update_minibatch` calls in turn
                from one state graphed, then eagerly, then eagerly again;
                what each `_loss_and_grads` returned, the parameters and
                the metrics after each, bit-equal to the eager run's (the
                sept_cnn agent under cuDNN's deterministic algorithms; with
                its default ones, whose eager run differs from itself,
                within NONDETERMINISTIC_ROOM times that run's own worst
                difference); one capture and a replay a call;
                what the first call returned unchanged by the later ones;
                fused_adam.LAUNCHES and networks.CONV_ENCODER as eager;
                under torch.profiler a replay's GEMM (and cuDNN conv)
                kernels; ms a call, the first call's seconds (warm-up and
                capture), and what each run added to the peak memory
Then the kernels' summary line and, last, the device line. Any failed check
raises and the script exits non-zero. Without a CUDA device it exits 2 and
runs nothing.
"""
import contextlib
import dataclasses
import hashlib
import io
import json
import math
import os
import subprocess
import sys
import time

T0 = time.time()

NUM_ENVS = 4096
RAGGED_ENVS = 4093     # a multiple of neither block's envs (32, 16)
MAIN_STEPS = 4
PATH_STEPS = 2
# the engine's solver configurations beside the default, and the kernels
# each launches per control step (n_substeps = 2 unless stated)
PATHS = (
    ("implicit", dict(tgs_step=False), {"cholesky_solve_blocked_t": 2}),
    ("one_substep", dict(n_substeps=1), {"cholesky_solve_blocked_t": 1}),
    ("implicit_dense", dict(tgs_step=False, blocked_solver=False),
     {"cholesky_solve_soa_t": 2}),
    ("tgs_batch_major", dict(batch_major_solver=True),
     {"to_env_last": 1, "cholesky_factor_blocked_t": 1,
      "cholesky_resolve_blocked": 2}),
    ("implicit_batch_major", dict(tgs_step=False, batch_major_solver=True),
     {"to_env_last": 2, "cholesky_solve_blocked_t": 2}),
    ("gram", dict(gram_kernel=True),
     {"gram_diag": 1, "to_env_last": 1, "cholesky_factor_blocked_t": 1,
      "cholesky_resolve_blocked_t": 2}),
    ("gram_batch_major", dict(gram_kernel=True, batch_major_solver=True),
     {"gram_diag": 1, "to_env_last": 1, "cholesky_factor_blocked_t": 1,
      "cholesky_resolve_blocked": 2}),
    ("gram_implicit", dict(gram_kernel=True, tgs_step=False),
     {"gram_diag": 2, "to_env_last": 2, "cholesky_solve_blocked_t": 2}),
    ("gram_implicit_dense",
     dict(gram_kernel=True, tgs_step=False, blocked_solver=False),
     {"gram_diag": 2, "to_env_last": 2, "cholesky_solve_soa_t": 2}),
    ("two_operand", dict(sqrt_gram=False),
     {"cholesky_factor_blocked_t": 1, "cholesky_resolve_blocked_t": 2}),
)
# the engine's contact variants at the bench configuration (name, engine
# fields, bodies fit to the SMPL fixture, kernels per control step). With
# self-contact both steps solve densely (reduced._arrow_exact); the TGS step
# refactors its one LHS each substep.
DENSE2 = {"cholesky_solve_soa_t": 2}
ARROW = {"cholesky_factor_blocked_t": 1, "cholesky_resolve_blocked_t": 2}
GRAM = {"gram_diag": 1, "to_env_last": 1}
CONTACT_PATHS = (
    ("self_contact", dict(self_contact=True), False, DENSE2),
    ("mesh", dict(mesh_contacts=True), False, ARROW),
    ("mesh_smpl", dict(mesh_contacts=True), True, ARROW),
    ("terrain_patch", dict(terrain_patch=32), False, ARROW),
    ("self_mesh_implicit",
     dict(self_contact=True, mesh_contacts=True, tgs_step=False), False,
     DENSE2),
    ("gram_self", dict(gram_kernel=True, self_contact=True), False,
     {**GRAM, **DENSE2}),
    ("gram_mesh", dict(gram_kernel=True, mesh_contacts=True), False,
     {**GRAM, **ARROW}),
    ("gram_self_mesh",
     dict(gram_kernel=True, self_contact=True, mesh_contacts=True), False,
     {**GRAM, **DENSE2}),
)
# configurations of the reference_contacts phase (8 envs, card vs CPU, from
# the folded-arm pose)
CONTACT_REFERENCES = (dict(self_contact=True), dict(mesh_contacts=True),
                      dict(terrain_patch=32),
                      dict(gram_kernel=True, self_contact=True))
# the getup fall bank: envs whose summed contact force is above this are on
# the ground; at least GROUND_SHARE of them must be (a few are thrown clear
# by the drop, in the JAX package's bank too), and the median root must lie
# above the terrain and below the 0.6 m it was dropped from. Single bodies
# can end inside the heightfield's steep cell ramps (stairs, stone edges),
# where the contact normal is near horizontal: the deepest collider is
# printed, not gated.
GROUND_FORCE_N, GROUND_SHARE, DROP_M = 1.0, 0.9, 0.6
# the bench's training configuration (bench.py:133-138)
TRAIN_ENVS = 1600
# the discriminator reward's cap, −log(1e-4)·disc_reward_scale: a mean at
# the cap means saturated logits
DISC_REWARD_CAP = -math.log(1e-4) * 2.0
# one update on the card against the CPU: the tolerances of
# tests/test_torch_train.py (loss terms, gradient leaves, updates per entry
# in units of lr); sums run in other orders on the two devices
LOSS_REL, GRAD_REL, UPDATE_LR = 1e-4, 1e-4, 1e-3
# the LocoVal epoch at the training configuration: a warm-up epoch, then
# timed epochs (steps 32-191: every env latches in them), then evaluation
VALUE_EPOCHS = 5
VALUE_GAMES = 2
# one valuenet update on the card against the CPU: the loss and each
# gradient leaf relative to their magnitude, the updated parameters per
# entry in units of lr_t; the EmLoco loss and its gradient on this many
# trajectories
VALUE_LOSS_REL, VALUE_GRAD_REL, VALUE_UPDATE_LR = 1e-5, 1e-5, 1e-3
EML_ROWS, EML_REL = 4096, 1e-5
# the entry points' trajectory optimization, and the card-vs-CPU check of
# optimize_trajectory (float32 work over 20 Adam steps)
OPT_BATCH, OPT_STEPS = 4096, 200
OPT_REF_BATCH, OPT_REF_STEPS, OPT_REF_TOL = 64, 20, 1e-4
# the sensor variants' card-vs-CPU observe: envs compared, and how near (m)
# a sensor point may lie to a terrain cell edge or a footprint box edge and
# be excused (it may read the other side on the other device)
SENSOR_REF_ENVS, EDGE_M = 8, 1e-4
# timed epochs of the crowd and bf16 training configurations after a warm-up
CROWD_EPOCHS = 1
# bfloat16 heads on the card against the CPU, relative to each head's
# largest |output|: each bf16 layer rounds to 8 bits, its sums in other
# orders on the two devices
BF16_HEAD_REL = 2.0 ** -6
# query_value_gradient, card against CPU
QVG_ENVS, QVG_REL = 64, 1e-5
# the perturbations phase: control steps at the training configuration's
# envs with both noises, pushes and projectiles every 8 steps, hard-negative
# sampling, episodes of 24 steps (so that some end by truncation and the
# motions' success rates differ); a discriminator loss below this is a
# discriminator that separates every sample
PERTURB_STEPS = 32
PERTURB = dict(obs_noise_std=0.05, action_noise_std=0.05, push_interval=8,
               projectile_interval=8, hard_negative=True, episode_length=24)
D_LOSS_FLOOR = 1e-3
# configurations of the reference_implicit phase (8 envs, card vs CPU)
REFERENCES = (dict(tgs_step=False), dict(batch_major_solver=True),
              dict(gram_kernel=True), dict(sqrt_gram=False))
# the predictor phases: the jta preset at full width, the CLI's defaults
# (batch 10, 20 steps an epoch), the frozen LocoVal net's seed, the CPU
# generator of the card-vs-CPU step's dropout draws; the tolerances of
# train_reference for that step, 1e-4 of the largest |output| for predict;
# evaluation on the JTA fixture's windows (20 batches on the card, 4 and 2
# of them against the CPU), each metric within 1e-4 of its magnitude, a
# mode within 1e-5 of the filter's threshold excused
PRED_BATCH, PRED_STEPS, PRED_VNET_SEED, PRED_REF_SEED = 10, 20, 11, 12
PRED_PREDICT_REL = 1e-4
PRED_EVAL_BATCHES, PRED_EVAL_SEED = 20, 2
PRED_REF_BATCHES, PRED_REF_LENGTH_BATCHES = 2, 1
PRED_EVAL_REL, PRED_EDGE = 1e-4, 1e-5
# the EqMotion phases: the CLI's defaults (batch 10, 20 steps an epoch) on
# synthetic ETH scenes of 4 agents, the EmLoco loss at the CLI's weight
# through a LocoVal net (velocity only) from its own seed; the float32
# step's loss terms held at 1e-4 against the CPU; rollout_with_rewards for
# the length of save_rollout_gif's GIF; scenes exported as a bank
EQ_BATCH, EQ_AGENTS, EQ_STEPS, EQ_VALUE_W = 10, 4, 20, 0.1
EQ_VNET_SEED, EQ_DATA_SEED = 13, 14
EQ_LOSS32_REL = 1e-4
GIF_STEPS = 90
EXPORT_SCENES = 32
# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s; non-tensor-core
# f32 FLOP/s, the peak of every kernel's bound but gram_diag's; dense bf16
# tensor-core FLOP/s (float32 sums), the peak of gram_diag's bound on bf16
# rows
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
BF16_TC_FLOP_S = 989e12
# Kernel vs plain version: both do the same float32 operations in the same
# order (the library is built without multiply-add contraction), so they
# should agree to the last bit; 1e-5 of the largest magnitude leaves room for
# a few ulps and nothing more. The factor, the resolve, the fused solve, the
# batch-major resolve, the dense solve and gram_diag, whose redesigns for the
# card keep every entry's roundings, must be bit-equal.
KERNEL_RTOL = 1e-5
# Whole step on the card vs on the CPU: matmul sums run in another order, and
# a Jacobian row entry that rounds to the other bfloat16 neighbour moves by
# 2^-8 of its size; one bfloat16 ulp (0.4%) of each quantity's magnitude.
STEP_RTOL = 2.0 ** -8
# Tensor-core Gram vs its plain version, per entry, in units of the sum of
# |products| (plus |d| on the diagonal): two float32 sums of M ≤ 304 exact
# products in different orders lie within 304·2⁻²⁴ of that sum each, or
# 304·2⁻²³ where the tensor core truncates; together under 2⁻¹³.
PROBE_TOL = 2.0 ** -13
# solver_kernels' outputs that must be bit-equal to their plain versions
BIT_EQUAL = ("solve", "resolve_bm", "solve_soa")
# The optimizer's kernel where the clip engages: its norm sums in float64 in
# another order than the plain version's float32 sums; its step must be the
# plain version's at a norm within NORM_ULP ulp of the plain version's own,
# bit for bit (tests/test_torch_fused_adam.py's NORM_ULP).
NORM_ULP = 16
CLIP_ADAM_SEED = 24
# minibatch updates a run of the loss_graph phase; the bench's AMP batch;
# the graphed loss's room over the eager run's own worst difference where
# that run differs from itself (cuDNN's default algorithms; 0 room where
# it does not)
LOSS_GRAPH_CALLS = 6
BENCH_AMP_BATCH = 1280
NONDETERMINISTIC_ROOM = 10.0
# cuDNN's convolution kernels, as port_bench/metrics/conv_ms.crowd.py names
# them
CONV_KERNELS = r"cudnn|convolve|fprop|dgrad|wgrad"
# the probe's variants, in the order of scripts/gram_kernel_probe.py
PROBE_VARIANTS = ("einsum_envlast", "einsum_bm", "kernel_at_b", "kernel_dual",
                  "kernel_dual_batched8", "kernel_dual_batched32",
                  "kernel_at_b32", "build_rt_xla", "relayout_pallas",
                  "xla_transpose")


def emit(phase, **kw):
    print(json.dumps({"phase": phase, "t": round(time.time() - T0, 3), **kw}),
          flush=True)


def rel_err(a, b):
    """(max |a − b|, that over max |b|) — b is the reference."""
    err = (a.double() - b.double()).abs().max().item()
    return err, err / max(b.double().abs().max().item(), 1e-30)


def time_ms(fn, iters):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def random_arrow_spd(n, arrow, pattern, gen, dev):
    """A = Pᵀ (L0 L0ᵀ) P with L0 random lower in the block-arrow pattern
    (new order), so A is SPD with exact zeros outside the pattern. Env 0's
    first pivot is 1e-14, below the kernel's clamp; env 1 has a pivot that
    cancels to about 1e-6."""
    import torch
    from emloco_tpu_torch.physics import linalg
    chunks, limbs, s_lo = arrow
    perm = torch.as_tensor(linalg._plan(chunks, limbs, s_lo)[0],
                           dtype=torch.long, device=dev)
    M = perm.numel()
    mask = torch.as_tensor(pattern, dtype=torch.float32, device=dev)
    # off-diagonals N(0, 0.1²): a random triangular factor with unit-scale
    # entries is exponentially ill-conditioned in its size
    L0 = (0.1 * torch.randn((M, M, n), generator=gen, device=dev)
          * mask[:, :, None])
    d = torch.arange(M, device=dev)
    L0[d, d] = 0.5 + torch.rand((M, n), generator=gen, device=dev)
    L0[0, 0, 0] = 1e-7
    L0[5, 5, 1] = 1e-3
    A_new = torch.einsum("ikn,jkn->ijn", L0, L0)
    A = torch.empty_like(A_new)
    A[perm[:, None], perm[None, :]] = A_new
    return A.contiguous()


def dense_spd(n, M, gen, dev):
    """A = I + (0.1/M)·X Xᵀ, X standard normal: SPD with every entry
    nonzero. Off-diagonals are about 0.0115 against a diagonal of about
    1.1, so the part inside the block-arrow pattern is SPD too (diagonally
    dominant), and the factor of that part has no clamped pivot."""
    import torch
    X = torch.randn((M, M, n), generator=gen, device=dev)
    A = (0.1 / M) * torch.einsum("ikn,jkn->ijn", X, X)
    d = torch.arange(M, device=dev)
    A[d, d] += 1.0
    return A.contiguous()


def arrow_work(pattern):
    """Per-env flops of the factor and of one resolve, and the in-pattern
    entries of L, counted on the block-arrow pattern."""
    M = pattern.shape[0]
    offdiag = int(pattern.sum()) - M
    factor = 0
    for k in range(M):
        rows = [i for i in range(k + 1, M) if pattern[i, k]]
        r = len(rows)
        factor += 1 + r + r * (r + 1)          # sqrt, r divides, r(r+1)/2 FMS
    resolve = 2 * (2 * offdiag + M)            # two sweeps
    return factor, resolve, int(pattern.sum())


_PL = "emloco_tpu/physics/pallas_linalg.py"
_PROBE = "scripts/gram_kernel_probe.py"
KERNELS = (   # summary key, kernel, CUDA source, file:line of the TPU kernel
    ("factor", "cholesky_factor_blocked_t", "block_arrow_cholesky.cu",
     f"{_PL}:303"),
    ("resolve", "cholesky_resolve_blocked_t", "block_arrow_cholesky.cu",
     f"{_PL}:334"),
    ("solve", "cholesky_solve_blocked_t", "block_arrow_solve.cu",
     f"{_PL}:258"),
    ("resolve_bm", "cholesky_resolve_blocked", "block_arrow_solve.cu",
     f"{_PL}:450"),
    ("solve_soa", "cholesky_solve_soa_t", "dense_cholesky.cu", f"{_PL}:62"),
    ("to_env_last", "to_env_last", "to_env_last.cu", f"{_PL}:380"),
    ("gram_diag", "gram_diag", "gram_diag.cu", f"{_PL}:508"),
    ("gram_dual", "gram_dual", "gram_dual.cu", f"{_PROBE}:63"),
    ("gram_dual_batched", "gram_dual_batched", "gram_dual.cu",
     f"{_PROBE}:97"),
)


def recording(inner, log, extract):
    """A stand-in for the engine function `inner` that appends
    extract(args, result), on the CPU, to `log` at each call."""
    def rec(*args, **kw):
        out = inner(*args, **kw)
        log.append(extract(args, out))
        return out

    return rec


def contact_flags(args, out):
    """_contact_and_jacobians(model, terrain, state, cfg): (active flags,
    penetrations) of the ground rows and then the self pairs' rows, (N, C)
    each, and the number of ground rows."""
    import torch
    from emloco_tpu_torch.physics import reduced as R
    nrm, active, h, radius, pts = out[4], out[5], out[9], out[10], out[11]
    ng = radius.shape[1]
    pen = (h + radius - pts[..., 2]) * nrm[:, :ng, 2]
    if out[13] is not None:
        model, st = args[0], args[2]
        pen = torch.cat([pen, R._self_contact_geometry(
            model, st.body_x, st.body_q)[3]], dim=1)
    return active.cpu() > 0, pen.cpu(), ng


def spring_errors(args, out):
    """_gravity_bias_spring(model, x, q, v_b, w_b, u, target_q, gvec): the
    PD spring's error exp-map (N, 23, 3), recomputed as the engine forms
    it."""
    from emloco_tpu_torch.ops import quat
    from emloco_tpu_torch.physics import reduced as R
    q, target_q = args[2], args[6]
    qp = q[:, R._statics(q.device)["parent_j"]]
    q_rel = quat.mul(quat.conjugate(qp), q[:, 1:])
    return quat.to_exp_map(quat.mul(q_rel, quat.conjugate(target_q))).cpu()


RECORDED = (("_contact_and_jacobians", contact_flags),
            ("_gravity_bias_spring", spring_errors))


def contact_differences(log_g, log_c, keep):
    """Per call of _contact_and_jacobians: the kept envs' contacts active on
    the card only and on the CPU only, each with (env, contact, penetration
    on the card, on the CPU) (contacts from the number of ground rows on are
    self pairs), and the largest penetration difference."""
    calls = []
    envs = keep.nonzero()[:, 0]
    for (act_g, pen_g, ng), (act_c, pen_c, _) in zip(log_g, log_c):
        act_g, act_c = act_g[keep], act_c[keep]
        pen_g, pen_c = pen_g[keep], pen_c[keep]

        def listed(mask):
            return [(int(envs[e]), int(c), pen_g[e, c].item(),
                     pen_c[e, c].item()) for e, c in mask.nonzero()]

        calls.append(dict(card_only=listed(act_g & ~act_c),
                          cpu_only=listed(act_c & ~act_g),
                          active_card=int(act_g.sum()),
                          active_cpu=int(act_c.sum()), ground_rows=ng,
                          active_self_cpu=int(act_c[:, ng:].sum()),
                          max_pen_diff=(pen_g - pen_c).abs().max().item()))
    return calls


def spring_differences(log_g, log_c, keep):
    """Per substep: the kept envs' joints whose PD error exp-map is exactly
    zero on one device only (to_exp_map returns 0 once the error
    quaternion's w rounds to 1), each with (env, joint, |error| on the card,
    on the CPU), and the largest error difference in rad."""
    calls = []
    envs = keep.nonzero()[:, 0]
    for th_g, th_c in zip(log_g, log_c):
        th_g, th_c = th_g[keep], th_c[keep]
        zero_g, zero_c = (th_g == 0).all(-1), (th_c == 0).all(-1)
        n_g, n_c = th_g.norm(dim=-1), th_c.norm(dim=-1)
        calls.append(dict(
            zero_on_one_device=[(int(envs[e]), int(j), n_g[e, j].item(),
                                 n_c[e, j].item())
                                for e, j in (zero_g ^ zero_c).nonzero()],
            max_error_diff=(th_g - th_c).abs().max().item()))
    return calls


def card_vs_cpu(phase, cfg, env, gen, start=None, **extra):
    """One step of an 8-env copy of `env` (config `cfg`) on the card and on
    the CPU from the same reset state (passed through `start(env, state)`
    where given) and actions; fails past STEP_RTOL. Reports, for each call
    of _contact_and_jacobians, the contacts whose `active` flag differs between
    the two devices, and for each substep the joints whose PD error is zero
    on one device only. Returns its calls as the
    card and the CPU saw them."""
    import torch
    from emloco_tpu_torch.envs import PedestrianTerrainEnv
    from emloco_tpu_torch.physics import reduced as R
    small = dataclasses.replace(cfg, num_envs=8)
    dev, cpu = env.device, torch.device("cpu")
    env_g = PedestrianTerrainEnv(small, env.terrain, env.motion_lib,
                                 device=dev)
    env_c = PedestrianTerrainEnv(small, env.terrain.to(cpu),
                                 env.motion_lib.to(cpu), device=cpu)
    st_g = env_g.reset(torch.Generator(device=dev).manual_seed(3))
    if start is not None:
        st_g = start(env_g, st_g)
    st_c = st_g.to(cpu).replace(rng=torch.Generator().manual_seed(3))
    act = 0.3 * torch.randn((8, small.num_actions), generator=gen,
                            device=dev)
    logs = ({}, {})
    inner = {name: getattr(R, name) for name, _ in RECORDED}

    def arm(log):
        for name, extract in RECORDED:
            log[name] = []
            setattr(R, name, recording(inner[name], log[name], extract))

    try:
        arm(logs[0])
        st_g, out_g = env_g.step(st_g, act)
        arm(logs[1])
        st_c, out_c = env_c.step(st_c, act.cpu())
    finally:
        for name, fn in inner.items():
            setattr(R, name, fn)
    keep = ~(out_g.done.cpu() | out_c.done)
    checks = {}
    for name, a, c in (("u", st_g.physics.u, st_c.physics.u),
                       ("body_x", st_g.physics.body_x, st_c.physics.body_x),
                       ("obs", out_g.obs, out_c.obs),
                       ("reward", out_g.reward, out_c.reward)):
        checks[name] = rel_err(a.cpu()[keep], c[keep])[1]
    emit(phase, **extra, envs_compared=int(keep.sum()), max_rel_err=checks,
         tolerance_rel=STEP_RTOL,
         contacts=contact_differences(
             *(log["_contact_and_jacobians"] for log in logs), keep),
         springs=spring_differences(
             *(log["_gravity_bias_spring"] for log in logs), keep))
    if int(keep.sum()) == 0 or not max(checks.values()) <= STEP_RTOL:
        raise SystemExit(f"card and CPU disagree on one step ({extra}): "
                         f"{checks}")
    return [log["_contact_and_jacobians"] for log in logs]


def solver_kernels(cases, arrow):
    """Kernels 3, 5, 6 and 7 against their plain versions on each case,
    the fused and the dense solve bit for bit; the fused solve against
    factor + resolve
    and the batch-major resolve against the env-last one, bit for bit.
    Returns the max abs errors."""
    import torch
    from emloco_tpu_torch.physics import linalg
    errs = dict.fromkeys(("solve", "resolve_bm", "solve_soa", "to_env_last"),
                         0.0)
    for name, (A, b) in cases.items():
        N, M = A.shape[-1], A.shape[0]
        A_bm = A.permute(2, 0, 1).contiguous()
        b_bm = b.T.contiguous()
        # the (N, 80, 75) staging shape, its 5 pad rows NaN: the crop must
        # drop them
        staged = torch.cat([A_bm, torch.full((N, 5, M), float("nan"),
                                             device=A.device)], 1)
        L = linalg.cholesky_factor_blocked_t(A, *arrow)
        x_split = linalg.cholesky_resolve_blocked_t(L, b, *arrow)
        outs = {
            "solve": (linalg.cholesky_solve_blocked_t(A, b, *arrow),
                      linalg.solve_blocked_plain(A, b, *arrow)),
            "resolve_bm": (linalg.cholesky_resolve_blocked(L, b_bm, *arrow),
                           linalg.resolve_blocked_bm_plain(L, b_bm, *arrow)),
            "solve_soa": (linalg.cholesky_solve_soa_t(A, b),
                          linalg.solve_soa_plain(A, b)),
            "to_env_last": (linalg.to_env_last(A_bm),
                            linalg.to_env_last_plain(A_bm)),
            "to_env_last_staged": (linalg.to_env_last(staged, out_rows=M),
                                   linalg.to_env_last_plain(staged, M)),
        }
        torch.cuda.synchronize()
        report, bad = {}, []
        for key, (k, p) in outs.items():
            e, r = rel_err(k, p)
            finite = bool(torch.isfinite(k).all())
            report[key] = dict(max_abs_err=e, max_rel_err=r, finite=finite,
                               bit_equal=bool(torch.equal(k, p)))
            if not (finite and r <= KERNEL_RTOL) or (
                    key in BIT_EQUAL and not torch.equal(k, p)):
                bad.append(key)
            base = key.replace("_staged", "")
            errs[base] = max(errs[base], e)
        fused = bool(torch.equal(outs["solve"][0], x_split))
        bm = bool(torch.equal(outs["resolve_bm"][0], x_split.T))
        emit("solver_kernels", case=name, num_envs=N,
             tolerance_rel=KERNEL_RTOL, kernels=report,
             fused_equals_factor_then_resolve=fused,
             batch_major_equals_env_last=bm)
        if bad or not (fused and bm):
            raise SystemExit(f"solver kernels disagree on {name}: {bad}, "
                             f"fused = split {fused}, bm = env-last {bm}")
    return errs


def solver_times(A, b, L, arrow):
    """ms of kernels 3, 6, 7 and 5 (20 launches), of their plain versions
    (3 calls) and of a PyTorch call that computes the same function."""
    import torch
    from emloco_tpu_torch.physics import linalg
    A_bm = A.permute(2, 0, 1).contiguous()
    b_bm = b.T.contiguous()
    b3 = b_bm[:, :, None]
    L_bm = torch.linalg.cholesky(A_bm)

    def library_solve():
        return torch.cholesky_solve(b3, torch.linalg.cholesky(A_bm))

    return {
        "solve": dict(
            ms=time_ms(lambda: linalg.cholesky_solve_blocked_t(A, b, *arrow),
                       20),
            plain_ms=time_ms(lambda: linalg.solve_blocked_plain(A, b, *arrow),
                             3),
            library_ms=time_ms(library_solve, 20)),
        "resolve_bm": dict(
            ms=time_ms(lambda: linalg.cholesky_resolve_blocked(L, b_bm,
                                                               *arrow), 20),
            plain_ms=time_ms(
                lambda: linalg.resolve_blocked_bm_plain(L, b_bm, *arrow), 3),
            library_ms=time_ms(lambda: torch.cholesky_solve(b3, L_bm), 20)),
        "solve_soa": dict(
            ms=time_ms(lambda: linalg.cholesky_solve_soa_t(A, b), 20),
            plain_ms=time_ms(lambda: linalg.solve_soa_plain(A, b), 3),
            library_ms=time_ms(library_solve, 20)),
        "to_env_last": dict(
            ms=time_ms(lambda: linalg.to_env_last(A_bm), 20),
            plain_ms=time_ms(lambda: linalg.to_env_last_plain(A_bm), 3),
            library_ms=time_ms(lambda: A_bm.permute(1, 2, 0).contiguous(),
                               20)),
    }


def gram_inputs(env, state, engine, gen):
    """The Gram's inputs at the env's size: the two-operand merged rows of
    `state` with bf16 rows and with float32 rows (`rows_bf16=False`), and
    random float32 rows of the same shape with signed weights, each as
    (R, w, float32 diag)."""
    import torch
    from emloco_tpu_torch.physics import reduced as R
    cases = {}
    for name, bf16 in (("real_bf16", True), ("real_f32", False)):
        G, W, ground, *rest = R._contact_and_jacobians(
            env.model, env.terrain, state.physics,
            dataclasses.replace(engine, rows_bf16=bf16))
        rows, wv = R._merged_rows(env.model, G, W, ground)
        cases[name] = (rows, wv, rest[5].float())
    rows = cases["real_f32"][0]
    N, M, C = rows.shape
    dev = rows.device
    cases["random_f32"] = (
        torch.randn((N, M, C), generator=gen, device=dev),
        torch.randn((N, M), generator=gen, device=dev),
        torch.rand((N, C), generator=gen, device=dev))
    return cases


def gram_kernels(cases, phase="gram_kernel"):
    """gram_diag against its plain version on each case, batch-major and on
    the (N, 80, 75) staging shape, whose 75 rows are compared and which
    goes on through to_env_last cropped to 75; every output bit-equal (on
    bf16 rows the kernel sums the lower triangle and mirrors it, so this is
    the mirror's full-width check). Returns the max abs error."""
    import torch
    from emloco_tpu_torch.physics import linalg
    worst = 0.0
    for name, (Rr, w, d) in cases.items():
        N, M, C = Rr.shape
        staged_rows = C + (-C) % 16
        plain = linalg.gram_diag_plain(Rr, w, d)
        staged = linalg.gram_diag(Rr, w, d, out_rows=staged_rows)
        outs = {
            "batch_major": (linalg.gram_diag(Rr, w, d), plain),
            "staged_rows": (staged[:, :C], plain),
            "staged_then_env_last": (linalg.to_env_last(staged, out_rows=C),
                                     plain.permute(1, 2, 0)),
        }
        torch.cuda.synchronize()
        report, bad = {}, []
        for key, (k, p) in outs.items():
            e, r = rel_err(k, p)
            finite = bool(torch.isfinite(k).all())
            report[key] = dict(max_abs_err=e, max_rel_err=r, finite=finite,
                               bit_equal=bool(torch.equal(k, p)))
            if not (finite and r <= KERNEL_RTOL and torch.equal(k, p)):
                bad.append(key)
            worst = max(worst, e)
        emit(phase, case=name, num_envs=N, rows=M, cols=C,
             dtype=str(Rr.dtype), tolerance_rel=KERNEL_RTOL, outputs=report)
        if bad:
            raise SystemExit(f"gram_diag disagrees with its plain version "
                             f"on {name}: {bad}")
    return worst


def gram_times(Rr, w, d):
    """ms of gram_diag on the engine's env-last staging shape (20
    launches), of its plain version (3 calls) and of one PyTorch call of
    the same function, float32 `baddbmm` with TF32 off (operands cast
    before the timed region); for bf16 rows also a bf16 `bmm` with float32
    output on w∘R rounded to bf16, a yardstick of the tensor cores' speed,
    not of the same rounding. Also the bytes, flops and flop peak of the
    bound, and the multiply-adds the kernel sums (the lower triangle for
    bf16 rows, every entry for float32 rows)."""
    import torch
    from emloco_tpu_torch.physics import linalg
    N, M, C = Rr.shape
    staged_rows = C + (-C) % 16
    Rf = Rr.float()
    rw_t = (Rf * w.float()[..., None]).transpose(1, 2)
    D = torch.diag_embed(d)
    out = dict(
        ms=time_ms(lambda: linalg.gram_diag(Rr, w, d, out_rows=staged_rows),
                   20),
        plain_ms=time_ms(lambda: linalg.gram_diag_plain(Rr, w, d,
                                                        staged_rows), 3),
        library_ms=time_ms(lambda: torch.baddbmm(D, rw_t, Rf), 20))
    if Rr.dtype == torch.bfloat16:
        rw16_t = (Rr * w[..., None]).transpose(1, 2)
        out["library_bf16_ms"] = time_ms(
            lambda: torch.bmm(rw16_t, Rr, out_dtype=torch.float32), 20)
    rb = Rr.element_size()
    # R, w and d read once, the C x C sums written once (the staging rows
    # are not written); 2·M·C² flops of the sums, M·C of w∘R
    nbytes = N * (M * C * rb + M * rb + C * 4 + C * C * 4)
    nflops = N * (2 * M * C * C + M * C)
    peak = BF16_TC_FLOP_S if Rr.dtype == torch.bfloat16 else F32_FLOP_S
    entries = C * (C + 1) // 2 if Rr.dtype == torch.bfloat16 else C * C
    out["cuda_core_floor_ms"] = N * M * entries * 2 / F32_FLOP_S * 1e3
    return out, (nbytes, nflops, peak)


def probe_inputs(engine_rows, dev):
    """The probe kernels' inputs as (Rt, R, d): the probe's seed-0 operands
    at 4,096 envs (M = 304), the reset state's bf16 merged rows (M = 256)
    with Rt = (w∘R in bf16)ᵀ, and 64 envs of random rows with M = 37 (not a
    multiple of 8: scalar loads and a zero-filled last k16 step)."""
    import torch
    from emloco_tpu_torch.scripts import gram_kernel_probe
    R, _, d, Rt = gram_kernel_probe.operands(NUM_ENVS, dev)
    Re, we, de = engine_rows
    gen = torch.Generator(device=dev).manual_seed(4)
    Rr = torch.randn((64, 37, 75), generator=gen, device=dev).bfloat16()
    wr = torch.rand((64, 37), generator=gen, device=dev).bfloat16()
    return {
        "probe_seed0": (Rt, R, d),
        "engine_bf16": ((we[..., None] * Re).transpose(1, 2).contiguous(),
                        Re.contiguous(), de.contiguous()),
        "ragged": ((wr[..., None] * Rr).transpose(1, 2).contiguous(), Rr,
                   torch.rand((64, 75), generator=gen, device=dev)),
    }


def probe_kernels(cases):
    """gram_dual and gram_dual_batched (blocks of 8 and 32) against
    gram_dual_plain on each case: per entry within PROBE_TOL of the sum of
    |products| plus |d| on the diagonal, the three outputs bit-equal,
    finite, and each kernel launched; reports the SHA-256 of each output's
    bytes. Returns the max abs errors."""
    import torch
    from emloco_tpu_torch.physics import linalg
    errs = {"gram_dual": 0.0, "gram_dual_batched": 0.0}
    for name, (Rt, R, d) in cases.items():
        N, C, M = Rt.shape
        linalg.reset_launch_counts()
        outs = {"gram_dual": linalg.gram_dual(Rt, R, d),
                "gram_dual_batched": linalg.gram_dual_batched(Rt, R, d),
                "gram_dual_batched32": linalg.gram_dual_batched(
                    Rt, R, d, block_envs=32)}
        torch.cuda.synchronize()
        launches = {k: linalg.LAUNCHES[k]
                    for k in ("gram_dual", "gram_dual_batched")}
        plain = linalg.gram_dual_plain(Rt, R, d)
        gate = PROBE_TOL * (torch.bmm(Rt.abs().double(), R.abs().double())
                            + torch.diag_embed(d.abs().double()))
        report, bad = {}, []
        for key, k in outs.items():
            diff = (k.double() - plain.double()).abs()
            ratio = (diff / gate.clamp_min(1e-300)).max().item()
            finite = bool(torch.isfinite(k).all())
            report[key] = dict(max_abs_err=diff.max().item(),
                               max_err_over_gate=ratio, finite=finite,
                               bit_equal_plain=bool(torch.equal(k, plain)),
                               sha256=hashlib.sha256(
                                   k.contiguous().cpu().numpy().tobytes()
                               ).hexdigest())
            if not (finite and ratio <= 1.0):
                bad.append(key)
            base = key.replace("32", "")
            errs[base] = max(errs[base], diff.max().item())
        same = all(torch.equal(outs["gram_dual"], o) for o in outs.values())
        emit("probe_kernels", case=name, num_envs=N, rows=M, cols=C,
             gate="2^-13 x (|Rt|.|R| + |d| on the diagonal)",
             kernels=report, dual_equals_batched=same, launches=launches)
        if bad or not same or launches != {"gram_dual": 1,
                                           "gram_dual_batched": 2}:
            raise SystemExit(f"probe kernels disagree on {name}: {bad}, "
                             f"bit-equal {same}, launches {launches}")
        del outs, plain, gate
    return errs


def probe_times(Rt, R, d):
    """ms of gram_dual and gram_dual_batched at the probe's shapes (20
    launches; batched also at blocks of 32), of their plain version (3
    calls) and of one bf16 `bmm` with float32 output plus an in-place
    diagonal add, the same function. Also the bound's bytes (Rt, R and d
    read once, the C x C output written once) and flops."""
    import torch
    from emloco_tpu_torch.physics import linalg
    N, C, M = Rt.shape

    def library():
        out = torch.bmm(Rt, R, out_dtype=torch.float32)
        out.diagonal(dim1=1, dim2=2).add_(d)
        return out

    plain_ms = time_ms(lambda: linalg.gram_dual_plain(Rt, R, d), 3)
    library_ms = time_ms(library, 20)
    times = {
        "gram_dual": dict(
            ms=time_ms(lambda: linalg.gram_dual(Rt, R, d), 20),
            plain_ms=plain_ms, library_ms=library_ms),
        "gram_dual_batched": dict(
            ms=time_ms(lambda: linalg.gram_dual_batched(Rt, R, d), 20),
            ms_block32=time_ms(lambda: linalg.gram_dual_batched(
                Rt, R, d, block_envs=32), 20),
            plain_ms=plain_ms, library_ms=library_ms),
    }
    nbytes = N * (2 * C * M * 2 + C * 4 + C * C * 4)
    nflops = N * (2 * M * C * C + C)
    return times, (nbytes, nflops)


def run_probe():
    """The probe at full size, its stdout captured; each line is echoed
    under the phase name. Returns (launch counts around it, its result)."""
    import torch
    from emloco_tpu_torch.physics import linalg
    from emloco_tpu_torch.scripts import gram_kernel_probe
    torch.cuda.synchronize()
    linalg.reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = gram_kernel_probe.main([])
    torch.cuda.synchronize()
    launches = dict(linalg.LAUNCHES)
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    for ln in lines:
        emit("probe", **ln)
    variants = [ln["variant"] for ln in lines if "ms" in ln]
    finite = all(bool(torch.isfinite(o).all()) for o in res["out"].values())
    if (tuple(variants) != PROBE_VARIANTS or not finite
            or not all(0 < ms < float("inf") for ms in res["ms"].values())
            or not (launches["gram_dual"] and launches["gram_dual_batched"])):
        raise SystemExit(f"probe run failed: variants {variants}, finite "
                         f"{finite}, launches {launches}")
    return launches, res


def drive_path(r, name, per_step, card, phase="paths", after=None,
               **extra):
    """A bench rollout `r` (another engine configuration or sensor): one
    warm-up, then PATH_STEPS control steps with the launch counts read
    around them. Fails unless the counts are `per_step` × PATH_STEPS (every
    other kernel 0) and everything is finite. `after(state)` adds entries
    to the printed line. Returns the launch counts and the last state."""
    import torch
    from emloco_tpu_torch.physics import linalg
    dev = r.env.device
    state = r.env.reset(torch.Generator(device=dev).manual_seed(0))
    state, _, _, _ = r.control_step(state)             # warm-up
    torch.cuda.synchronize()
    linalg.reset_launch_counts()
    t = time.time()
    finite = True
    for _ in range(PATH_STEPS):
        state, out, o, mu = r.control_step(state)
        finite &= bool(torch.isfinite(o).all() and torch.isfinite(mu).all())
    torch.cuda.synchronize()
    dt = time.time() - t
    launches = dict(linalg.LAUNCHES)
    ph = state.physics
    finite &= all(bool(torch.isfinite(v).all()) for v in (
        ph.u, ph.body_x, ph.body_q, ph.body_v, ph.body_w, ph.contact_force,
        out.obs, out.reward))
    want = dict.fromkeys(launches, 0)
    want.update({k: n * PATH_STEPS for k, n in per_step.items()})
    if after is not None:
        extra.update(after(state))
    emit(phase, path=name, **extra, steps=PATH_STEPS,
         num_envs=NUM_ENVS, seconds=round(dt, 4),
         env_steps_per_s=NUM_ENVS * PATH_STEPS / dt, card=card,
         launches=launches, finite=finite,
         mean_reward=out.reward.mean().item())
    if launches != want:
        raise SystemExit(f"path {name}: launch counts {launches}, "
                         f"expected {want}")
    if not finite:
        raise SystemExit(f"path {name} produced non-finite values")
    return launches, state


def train_solver_check(agent, ts):
    """One more control step of the trained policy (its mean action) from
    the timed epoch's last env state, with the inputs that the step passes
    to the block-arrow factor (the LHS, (75, 75, N)) and to both resolves
    (the right-hand sides, (75, N)) recorded; the factor and the resolves
    then run again on those inputs against their plain versions, held
    bit-equal as on the kernels phase's cases."""
    import torch
    from emloco_tpu_torch.physics import linalg
    from emloco_tpu_torch.physics import reduced as R
    names = ("cholesky_factor_blocked_t", "cholesky_resolve_blocked_t")
    inner = {name: getattr(R, name) for name in names}
    log = []

    def arm(name):
        def rec(*args):
            log.append((name, [a.clone() if torch.is_tensor(a) else a
                               for a in args]))
            return inner[name](*args)
        return rec

    env = agent.env
    with torch.no_grad():
        o = ts.obs_norm.normalize(env.observe(ts.env_state))
        mu, _ = agent._apply(ts.params, "actor", o)
        try:
            for name in names:
                setattr(R, name, arm(name))
            env.step(ts.env_state, mu)
        finally:
            for name, fn in inner.items():
                setattr(R, name, fn)
        (_, (A, *arrow)), *resolves = log
        L_k = linalg.cholesky_factor_blocked_t(A, *arrow)
        L_p = linalg.factor_blocked_plain(A, *arrow)
        x_k = [linalg.cholesky_resolve_blocked_t(L_k, b, *arrow)
               for _, (_, b, *_a) in resolves]
        x_p = [linalg.resolve_blocked_plain(L_p, b, *arrow)
               for _, (_, b, *_a) in resolves]
    torch.cuda.synchronize()
    return dict(
        num_envs=int(A.shape[-1]), calls=[name for name, _ in log],
        factor_bit_equal=bool(torch.equal(L_k, L_p)),
        factor_max_rel_err=rel_err(L_k, L_p)[1],
        resolve_bit_equal=[bool(torch.equal(k, p))
                           for k, p in zip(x_k, x_p)],
        resolve_max_rel_err=[rel_err(k, p)[1] for k, p in zip(x_k, x_p)],
        finite=bool(torch.isfinite(L_k).all()
                    and all(torch.isfinite(x).all() for x in x_k)))


def first_update(agent, pools, before):
    """The epoch's first update's inputs: the parameters and optimizer
    state before it, its minibatch, demo and replay blocks and dropout
    masks (drawn again from the generator state `before` held)."""
    import torch
    params, opt, rng_state = before
    gen = torch.Generator(device="cuda")
    gen.set_state(rng_state)
    mb, demo, replay, masks, _ = next(agent.minibatches(pools, gen))
    return params, opt, mb, demo, replay, masks


def train(card):
    """The training epoch at the bench's training configuration: a warm-up
    epoch, then a timed one part by part with the launch counts read around
    it. Returns the agent, the timed epoch's first update's inputs and the
    launch counts."""
    import torch
    from emloco_tpu_torch.learning import fused_adam
    from emloco_tpu_torch.physics import linalg
    from emloco_tpu_torch.rollout import build_train_bench
    t = time.time()
    agent, ts = build_train_bench(TRAIN_ENVS, "cuda", seed=0)
    p_init = {k: v.clone() for k, v in ts.params.items()}
    torch.cuda.synchronize()
    setup_s = time.time() - t
    t = time.time()
    ts, _ = agent.train_epoch(ts)                       # warm-up
    torch.cuda.synchronize()
    warm_s = time.time() - t

    linalg.reset_launch_counts()
    fused_adam.reset_launch_counts()
    t0 = time.time()
    ts, batch, last_obs = agent.rollout(ts)
    torch.cuda.synchronize()
    t1 = time.time()
    ts, pools = agent.prepare(ts, batch, last_obs)
    torch.cuda.synchronize()
    t2 = time.time()
    before = (ts.params, ts.opt_state, ts.rng.get_state())
    ts, metrics = agent.update(ts, pools)
    metrics = {k: v.item() for k, v in metrics.items()}
    t3 = time.time()
    launches = dict(linalg.LAUNCHES)
    fused = fused_adam.LAUNCHES["clip_adam"]
    steps = agent.cfg.horizon * TRAIN_ENVS
    finite = (all(math.isfinite(v) for v in metrics.values())
              and all(bool(torch.isfinite(v).all())
                      for v in ts.params.values()))
    moved = any(not torch.equal(ts.params[k], p_init[k]) for k in p_init)
    solver = train_solver_check(agent, ts)
    emit("train", num_envs=TRAIN_ENVS, config=dataclasses.asdict(agent.cfg),
         setup_seconds=round(setup_s, 3), warmup_epoch_seconds=warm_s,
         rollout_seconds=t1 - t0, prepare_seconds=t2 - t1,
         update_seconds=t3 - t2, epoch_seconds=t3 - t0,
         env_steps_per_s=steps / (t3 - t0), card=card, launches=launches,
         fused_optimizer_steps=fused, metrics=metrics, replay_filled=ts.replay_filled, finite=finite,
         params_moved=moved, solver_kernels_on_train_inputs=solver,
         max_memory_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    want = dict.fromkeys(launches, 0)
    want.update({"cholesky_factor_blocked_t": agent.cfg.horizon,
                 "cholesky_resolve_blocked_t":
                     agent.cfg.horizon * agent.env.cfg.engine.n_substeps})
    if launches != want:
        raise SystemExit(f"train: launch counts {launches}, expected {want}")
    want_fused = agent.cfg.mini_epochs * agent.cfg.num_minibatches
    if fused != want_fused:
        raise SystemExit(f"train: {fused} fused optimizer steps, expected "
                         f"{want_fused}")
    n_resolve = agent.env.cfg.engine.n_substeps
    if not (solver["finite"] and solver["factor_bit_equal"]
            and len(solver["resolve_bit_equal"]) == n_resolve
            and all(solver["resolve_bit_equal"])):
        raise SystemExit(f"train: the factor or resolve disagrees with its "
                         f"plain version on the step's own inputs: {solver}")
    if not (finite and moved and metrics["nonfinite_grad"] == 0
            and ts.replay_filled == 2 * steps
            and metrics["disc_reward"] < 0.99 * DISC_REWARD_CAP):
        raise SystemExit(
            f"train epoch failed: finite {finite}, moved {moved}, "
            f"nonfinite_grad {metrics['nonfinite_grad']}, replay_filled "
            f"{ts.replay_filled} (expected {2 * steps}), disc_reward "
            f"{metrics['disc_reward']} (cap {DISC_REWARD_CAP})")
    return agent, first_update(agent, pools, before), launches


GATES = ("loss_rel", "grad_rel", "step_lr", "update_lr")


def train_reference(agent, inputs, phase="train_reference", dtype=None,
                    gated=GATES):
    """One update of the timed epoch on the card against the same update on
    the CPU (the tolerances of tests/test_torch_train.py), in `dtype`
    (float64, or the inputs' float32 where None); fails where a measure in
    `gated` exceeds its tolerance."""
    import torch
    params, opt, mb, demo, replay, masks = inputs
    runs = {}
    for dev in ("cuda", "cpu"):
        def to(x):
            return x.to(dev, dtype) if x.is_floating_point() else x.to(dev)
        p = {k: to(v) for k, v in params.items()}
        o = opt.map_tensors(to)
        args = ({k: to(v) for k, v in mb.items()}, to(demo), to(replay),
                None if masks is None else tuple(to(m) for m in masks))
        t = time.time()
        total, terms, grads = agent._loss_and_grads(p, *args)
        p1, _, finite = agent._apply_grads(p, o, grads)
        terms["total"] = total
        finite = bool(finite)
        runs[dev] = dict(seconds=time.time() - t, finite=finite,
                         terms={k: v.item() for k, v in terms.items()},
                         grads={k: v.cpu() for k, v in grads.items()},
                         params={k: v.cpu() for k, v in p1.items()})
    card, cpu = runs["cuda"], runs["cpu"]
    p0 = {k: v.to("cpu", dtype) for k, v in params.items()}
    # the CPU optimizer's step on the card's gradients
    step_ref, _, _ = agent._apply_grads(
        p0, opt.map_tensors(lambda x: x.to("cpu", dtype)
                            if x.is_floating_point() else x.cpu()),
        card["grads"])
    lr = agent.cfg.lr
    term_err = {k: abs(card["terms"][k] - v) / max(abs(v), 1e-6)
                for k, v in cpu["terms"].items()}
    grad_err, step_err, update_err = {}, {}, {}
    for k, g in cpu["grads"].items():
        gtol = GRAD_REL * max(g.abs().max().item(), 1e-12)
        grad_err[k] = ((card["grads"][k] - g).abs().max().item()
                       / max(g.abs().max().item(), 1e-12))
        step_err[k] = ((card["params"][k].double() - step_ref[k].double())
                       .abs().max().item() / lr)
        clear = g.abs() >= gtol
        du = card["params"][k].double() - p0[k].double()
        rdu = cpu["params"][k].double() - p0[k].double()
        update_err[k] = ((du - rdu)[clear].abs().max().item() / lr
                         if bool(clear.any()) else 0.0)
    worst = dict(loss_rel=max(term_err.values()),
                 grad_rel=max(grad_err.values()),
                 step_lr=max(step_err.values()),
                 update_lr=max(update_err.values()))
    emit(phase, precision=str(dtype or mb["adv"].dtype).split(".")[-1],
         gated=list(gated), rows=int(mb["adv"].shape[0]),
         demo_rows=int(demo.shape[0]), replay_rows=int(replay.shape[0]),
         card_seconds=card["seconds"], cpu_seconds=cpu["seconds"],
         finite=[card["finite"], cpu["finite"]], terms_card=card["terms"],
         terms_cpu=cpu["terms"], worst=worst,
         tolerance=dict(loss_rel=LOSS_REL, grad_rel=GRAD_REL,
                        step_lr=UPDATE_LR, update_lr=UPDATE_LR),
         grad_rel_by_leaf=grad_err, update_lr_by_leaf=update_err)
    tol = dict(loss_rel=LOSS_REL, grad_rel=GRAD_REL, step_lr=UPDATE_LR,
               update_lr=UPDATE_LR)
    if not (card["finite"] and cpu["finite"]
            and all(worst[k] <= tol[k] for k in gated)):
        raise SystemExit(f"{phase}: the card's update disagrees "
                         f"with the CPU's: {worst}")


def relu_flips(agent, inputs):
    """Card against CPU, float32, through the update's loss on its inputs
    (train_reference's): for each layer a ReLU follows (the `*_mlp`
    stacks), the decisions the two devices take the other way (a
    pre-activation's sign) and those within 1e-6 of the layer's largest
    |pre-activation| on the CPU."""
    import torch
    params, _, mb, demo, replay, masks = inputs
    layers = {n: m for n, m in agent.net.named_modules()
              if "_mlp." in n and isinstance(m, torch.nn.Linear)}

    def trace(dev):
        rec = {n: [] for n in layers}
        hooks = [m.register_forward_hook(
            lambda mod, args, out, n=n: rec[n].append(out.detach().cpu()))
            for n, m in layers.items()]
        try:
            agent._loss_and_grads(
                {k: v.to(dev) for k, v in params.items()},
                {k: v.to(dev) for k, v in mb.items()}, demo.to(dev),
                replay.to(dev),
                None if masks is None else tuple(m.to(dev) for m in masks))
        finally:
            for h in hooks:
                h.remove()
        return rec

    card, cpu = trace("cuda"), trace("cpu")
    out = {}
    for name, zs in cpu.items():
        if zs:
            eps = 1e-6 * max(z.abs().max().item() for z in zs)
            out[name] = dict(
                flips=sum(int(((a > 0) != (z > 0)).sum())
                          for a, z in zip(card[name], zs)),
                within_1e6=sum(int((z.abs() < eps).sum()) for z in zs))
    return out


def main_reference(agent, first):
    """The main path's update on the card against the CPU: in float64 with
    every tolerance of train_reference, then in float32 with its loss terms
    held and its gradients and updates printed beside the count of ReLU
    decisions that the two devices take the other way. A pre-activation
    within rounding of zero on a few of the 2,560 rows flips its unit's
    decision, and that row's whole contribution moves the unit's gradient:
    either side is right, as in crowd_reference; float64 rounding meets
    none."""
    import torch
    train_reference(agent, first, dtype=torch.float64)
    train_reference(agent, first, gated=("loss_rel",))
    emit("train_reference",
         float32_relu_flips_card_vs_cpu=relu_flips(agent, first))


def value(card):
    """The LocoVal epoch at the bench's training configuration: a warm-up
    epoch, then VALUE_EPOCHS timed epochs part by part (collect, update)
    with the launch counts read around them, then `evaluate`. Returns the
    trainer, the last timed epoch's update inputs and the launch counts."""
    import torch
    from emloco_tpu_torch.physics import linalg
    from emloco_tpu_torch.rollout import build_value_bench
    t = time.time()
    trainer, vts = build_value_bench(TRAIN_ENVS, "cuda", seed=0)
    p_init = {k: v.clone() for k, v in vts.vnet_params.items()}
    torch.cuda.synchronize()
    setup_s = time.time() - t
    t = time.time()
    vts, _ = trainer.train_epoch(vts)                   # warm-up
    torch.cuda.synchronize()
    warm_s = time.time() - t

    torch.cuda.reset_peak_memory_stats()
    linalg.reset_launch_counts()
    T, N = trainer.cfg.horizon, TRAIN_ENVS
    latched = torch.zeros((N,), device="cuda")
    parts, metrics = [], []
    for _ in range(VALUE_EPOCHS):
        t0 = time.time()
        vts, s = trainer._collect(vts)
        torch.cuda.synchronize()
        t1 = time.time()
        last = (vts.vnet_params, vts.vnet_opt, s)
        vts, m = trainer.update(vts, s)
        torch.cuda.synchronize()
        t2 = time.time()
        latched += s["valid"].reshape(T, N).sum(0)
        parts.append(dict(collect_seconds=t1 - t0, update_seconds=t2 - t1,
                          env_steps_per_s=T * N / (t2 - t0)))
        metrics.append(m)
    launches = dict(linalg.LAUNCHES)
    metrics = [{k: v.item() for k, v in m.items()} for m in metrics]
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    n_latched = sum(m["num_latched"] for m in metrics)
    inv_frac = (sum(m["inverted_frac"] * m["num_latched"] for m in metrics)
                / max(n_latched, 1.0))
    min_latched = int(latched.min().item())
    finite = (all(math.isfinite(v) for m in metrics for v in m.values())
              and all(bool(torch.isfinite(v).all())
                      for v in vts.vnet_params.values()))
    moved = any(not torch.equal(vts.vnet_params[k], p_init[k])
                for k in p_init)
    t = time.time()
    vts, mse, corr = trainer.evaluate(vts, VALUE_GAMES)
    eval_s = time.time() - t
    epoch_s = sum(p["collect_seconds"] + p["update_seconds"] for p in parts)
    emit("value", num_envs=N, config=dataclasses.asdict(trainer.cfg),
         setup_seconds=round(setup_s, 3), warmup_epoch_seconds=warm_s,
         epochs=parts, metrics=metrics,
         env_steps_per_s=VALUE_EPOCHS * T * N / epoch_s, card=card,
         launches=launches, num_latched=n_latched,
         min_latched_per_env=min_latched, inverted_frac=inv_frac,
         finite=finite, params_moved=moved, max_memory_gb=peak_gb,
         evaluate=dict(games=VALUE_GAMES, mse=mse, corr=corr,
                       seconds=eval_s))
    n_sub = trainer.env.cfg.engine.n_substeps
    want = dict.fromkeys(launches, 0)
    want.update({"cholesky_factor_blocked_t": VALUE_EPOCHS * T,
                 "cholesky_resolve_blocked_t": VALUE_EPOCHS * T * n_sub})
    if launches != want:
        raise SystemExit(f"value: launch counts {launches}, expected {want}")
    if not (finite and moved and n_latched >= N and min_latched >= 1
            and 0 < inv_frac < 1 and math.isfinite(mse)
            and 0 <= mse <= 1):
        raise SystemExit(
            f"value epochs failed: finite {finite}, moved {moved}, latched "
            f"{n_latched} (at least {N}, every env: min {min_latched}), "
            f"inverted_frac {inv_frac}, evaluate mse {mse}")
    return trainer, last, launches


def value_reference(trainer, inputs):
    """One valuenet update of the last timed epoch (its samples, the
    parameters and optimizer state before it) on the card against the
    CPU; then the EmLoco loss and its gradient with respect to EML_ROWS of
    the epoch's trajectories under the updated parameters."""
    import torch
    from emloco_tpu_torch.learning.networks import embodied_motion_loss
    params, opt, s = inputs
    runs = {}
    for dev in ("cuda", "cpu"):
        p = {k: v.to(dev) for k, v in params.items()}
        t = time.time()
        loss, grads = trainer._loss_and_grads(
            p, {k: v.to(dev) for k, v in s.items()})
        p1, _ = trainer.tx.update(grads, opt.to(dev), p)
        p1 = {k: v.cpu() for k, v in p1.items()}
        runs[dev] = dict(seconds=time.time() - t, loss=loss.item(),
                         grads={k: v.cpu() for k, v in grads.items()},
                         params=p1)
    card, cpu = runs["cuda"], runs["cpu"]
    lr_t = trainer.tx.learning_rate(opt.count).item()
    # the CPU optimizer's step on the card's gradients
    step_ref, _ = trainer.tx.update(card["grads"], opt.to("cpu"),
                                    {k: v.cpu() for k, v in params.items()})
    grad_err = {k: (card["grads"][k] - g).abs().max().item()
                / max(g.abs().max().item(), 1e-30)
                for k, g in cpu["grads"].items()}
    # each update entry where the gradient stands clear of its tolerance
    # (below it Adam's direction follows the last bits of a cancellation);
    # the largest over every entry, with its gradient, is reported
    update_err, update_all, grad_at = {}, {}, {}
    for k, g in cpu["grads"].items():
        gmax = max(g.abs().max().item(), 1e-30)
        d = (card["params"][k].double() - cpu["params"][k].double()).abs()
        clear = g.abs() >= VALUE_GRAD_REL * gmax
        update_err[k] = (d[clear].max().item() / lr_t
                         if bool(clear.any()) else 0.0)
        i = int(d.argmax())
        update_all[k] = d.flatten()[i].item() / lr_t
        grad_at[k] = g.flatten()[i].abs().item() / gmax
    step_err = {k: (card["params"][k].double() - v.double()).abs().max()
                .item() / lr_t for k, v in step_ref.items()}
    loss_err = abs(card["loss"] - cpu["loss"]) / max(abs(cpu["loss"]),
                                                     1e-30)

    rows = {k: s[k][:EML_ROWS] for k in ("wp", "pose", "vel")}
    eml = {}
    for dev in ("cuda", "cpu"):
        p = {k: v.to(dev) for k, v in card["params"].items()}
        traj = rows["wp"].to(dev).requires_grad_()
        loss = embodied_motion_loss(
            lambda tr, po, ve: trainer._apply(p, tr, po, ve), traj,
            rows["pose"].to(dev), rows["vel"].to(dev))
        g, = torch.autograd.grad(loss, traj)
        eml[dev] = (loss.item(), g.cpu())
    eml_loss_err = (abs(eml["cuda"][0] - eml["cpu"][0])
                    / max(abs(eml["cpu"][0]), 1e-30))
    eml_grad_err = ((eml["cuda"][1] - eml["cpu"][1]).abs().max().item()
                    / max(eml["cpu"][1].abs().max().item(), 1e-30))
    worst = dict(loss_rel=loss_err, grad_rel=max(grad_err.values()),
                 update_lr=max(update_err.values()),
                 step_lr=max(step_err.values()),
                 eml_loss_rel=eml_loss_err, eml_grad_rel=eml_grad_err)
    emit("value_reference", rows=int(s["valid"].shape[0]),
         latched=int(s["valid"].sum().item()), count=int(opt.count.item()),
         lr_t=lr_t, card_seconds=card["seconds"], cpu_seconds=cpu["seconds"],
         loss_card=card["loss"], loss_cpu=cpu["loss"],
         eml_rows=EML_ROWS, eml_card=eml["cuda"][0], eml_cpu=eml["cpu"][0],
         worst=worst,
         tolerance=dict(loss_rel=VALUE_LOSS_REL, grad_rel=VALUE_GRAD_REL,
                        update_lr=VALUE_UPDATE_LR, step_lr=VALUE_UPDATE_LR,
                        eml_loss_rel=EML_REL, eml_grad_rel=EML_REL),
         grad_rel_by_leaf=grad_err, update_lr_by_leaf=update_err,
         update_lr_every_entry=update_all,
         its_grad_over_leaf_max=grad_at)
    finite = all(math.isfinite(x) for x in (card["loss"], cpu["loss"],
                                            eml["cuda"][0], eml["cpu"][0]))
    if not (finite and loss_err <= VALUE_LOSS_REL
            and worst["grad_rel"] <= VALUE_GRAD_REL
            and worst["update_lr"] <= VALUE_UPDATE_LR
            and worst["step_lr"] <= VALUE_UPDATE_LR
            and eml_loss_err <= EML_REL and eml_grad_err <= EML_REL):
        raise SystemExit(f"value_reference: the card disagrees with the "
                         f"CPU: {worst}")


def plausibility(card):
    """The entry points on the card: `train_value` for one epoch writes a
    valuenet checkpoint, `optimize_traj` reads it and optimizes OPT_BATCH
    trajectories for OPT_STEPS steps; then optimize_trajectory on the card
    against the CPU."""
    import tempfile

    import torch
    from emloco_tpu_torch import convert, optimize_traj, train_value
    from emloco_tpu_torch.analysis import optimize_trajectory
    from emloco_tpu_torch.learning import ValuePoseNet
    from emloco_tpu_torch.utils.checkpoint import (latest_checkpoint,
                                                   load_pytree)
    with tempfile.TemporaryDirectory() as out:
        buf = io.StringIO()
        t = time.time()
        with contextlib.redirect_stdout(buf):
            train_value.main(["--epochs", "1", "--out", out])
        train_s = time.time() - t
        for ln in buf.getvalue().splitlines():
            emit("plausibility", train_value=json.loads(ln))
        path = latest_checkpoint(out)
        if path is None:
            raise SystemExit("plausibility: train_value wrote no checkpoint")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = optimize_traj.main(
                ["--valuenet", path, "--batch-size", str(OPT_BATCH),
                 "--steps", str(OPT_STEPS)])
        line = json.loads(buf.getvalue().splitlines()[-1])
        tree, meta = load_pytree(path)
    values = res["values"]
    finite = bool(torch.isfinite(values).all()
                  and torch.isfinite(res["traj"]).all())
    origin_kept = bool(torch.equal(res["traj"][:, 0], res["traj0"][:, 0]))
    before, after = values[0].mean().item(), values[-1].mean().item()

    use = meta["config"]
    vnet = ValuePoseNet(**use, device="cuda")
    params = convert.valuenet_state_dict(tree)
    traj0 = res["traj0"][:OPT_REF_BATCH].cpu()
    runs = {}
    for dev in ("cuda", "cpu"):
        tr = traj0.to(dev)
        pose = (torch.zeros((OPT_REF_BATCH, 24, 3), device=dev)
                if use["use_pose"] else None)
        vel = (tr[:, 1] - tr[:, 0]) / 0.4 if use["use_vel"] else None
        traj, vals = optimize_trajectory(
            vnet, {k: v.to(dev) for k, v in params.items()}, tr, pose, vel,
            steps=OPT_REF_STEPS)
        runs[dev] = (traj.cpu(), vals.cpu())
    traj_err = (runs["cuda"][0] - runs["cpu"][0]).abs().max().item()
    value_err = (runs["cuda"][1] - runs["cpu"][1]).abs().max().item()
    emit("plausibility", card=card, train_value_seconds=train_s,
         checkpoint=os.path.basename(path), metadata=meta,
         optimize_traj=line, steps=OPT_STEPS, batch=OPT_BATCH,
         optimize_seconds=res["seconds"], value_before=before,
         value_after=after, finite=finite, origin_bit_equal=origin_kept,
         card_vs_cpu=dict(batch=OPT_REF_BATCH, steps=OPT_REF_STEPS,
                          traj_max_abs_err=traj_err,
                          value_max_abs_err=value_err,
                          tolerance=OPT_REF_TOL))
    if not (finite and origin_kept and after >= before
            and traj_err <= OPT_REF_TOL and value_err <= OPT_REF_TOL):
        raise SystemExit(
            f"plausibility failed: finite {finite}, origin kept "
            f"{origin_kept}, value {before} -> {after}, card vs CPU "
            f"{traj_err} / {value_err} (tolerance {OPT_REF_TOL})")


def near_edges(env, state):
    """(N, P) bool on the CPU: the sensor points that lie within EDGE_M of a
    terrain cell edge or (with group_obs under the velocity map) of a
    neighbour's footprint box edge; and every point of an env one of whose
    center-patch points lies within EDGE_M of a cell edge."""
    import torch
    from emloco_tpu_torch.envs import observations as obs
    from emloco_tpu_torch.ops import quat
    from emloco_tpu_torch.physics import body_frame_state
    cfg, hf = env.cfg, env.terrain
    pos, rot, _, _ = body_frame_state(env.model, state.physics)
    root, head = pos[:, 0], pos[:, env._head]
    heading = quat.calc_heading(rot[:, 0])
    grid = env.sensor_grid

    def near_cell(px, py):
        out = torch.zeros_like(px, dtype=torch.bool)
        for v, o in ((px, hf.origin[0]), (py, hf.origin[1])):
            g = (v - o) / hf.cell
            frac = g - torch.floor(g)
            out |= torch.minimum(frac, 1 - frac) * hf.cell < EDGE_M
        return out

    px, py = obs._rotate_grid_xy(heading, grid, head[:, :2])
    near = near_cell(px, py)
    cg = torch.as_tensor(obs.make_sensor_grid(0.15, 3), device=grid.device)
    cpx, cpy = obs._rotate_grid_xy(heading, cg, root[:, :2])
    near |= near_cell(cpx, cpy).any(-1, keepdim=True)
    if cfg.group_obs and cfg.velocity_map:
        k = min(5, cfg.obs_group_size - 1)
        _, flat = obs._nearest_in_group(root[:, :2], cfg.obs_group_size, k)
        nbr = root[flat.reshape(-1), :2].reshape(-1, k, 2)
        dx = (px[:, :, None] - nbr[:, None, :, 0]).abs()
        dy = (py[:, :, None] - nbr[:, None, :, 1]).abs()
        near |= (((dx - 0.25).abs() < EDGE_M)
                 | ((dy - 0.5).abs() < EDGE_M)).any(-1)
    return near


def obs_errors(cfg, o_g, o_c, near):
    """The observation `o_g` against the reference `o_c`, block by block
    (self, trajectory, sensor, crowd), each block's largest difference
    over its largest |reference|, save the sensor points `near` an edge
    (near_edges): (errors by block, the excused entries that differ by
    more than STEP_RTOL)."""
    import torch
    sd, S = cfg.self_obs_dim, 2 * cfg.num_traj_samples
    P, C = cfg.num_sensor_points, 3 if cfg.velocity_map else 1
    blocks = {"self": (0, sd), "traj": (sd, sd + S),
              "sensor": (sd + S, sd + S + P * C)}
    if cfg.group_obs:
        blocks["crowd"] = (sd + S + P * C, cfg.obs_dim)
    excused = torch.zeros_like(o_c, dtype=torch.bool)
    excused[:, sd + S:sd + S + P * C] = near.repeat_interleave(C, -1)
    errs, listed = {}, []
    for blk, (a, b) in blocks.items():
        g, c, ex = o_g[:, a:b], o_c[:, a:b], excused[:, a:b]
        scale = max(c.abs().max().item(), 1e-6)
        diff = (g - c).abs()
        errs[blk] = (diff * ~ex).max().item() / scale
        for e, j in ((diff > STEP_RTOL * scale) & ex).nonzero().tolist():
            listed.append(dict(env=e, entry=a + j, card=o_g[e, a + j].item(),
                               cpu=o_c[e, a + j].item()))
    return errs, listed


def sensor_reference(r, name, card):
    """A reset and stepped state of SENSOR_REF_ENVS envs of the variant `r`:
    the card's observe against the CPU's, block by block (self, trajectory,
    sensor, crowd), save the sensor points near an edge."""
    import torch
    from emloco_tpu_torch.envs import PedestrianTerrainEnv
    small = dataclasses.replace(r.cfg, num_envs=SENSOR_REF_ENVS)
    dev, cpu = r.env.device, torch.device("cpu")
    env_g = PedestrianTerrainEnv(small, r.env.terrain, r.env.motion_lib,
                                 device=dev)
    env_c = PedestrianTerrainEnv(small, r.env.terrain.to(cpu),
                                 r.env.motion_lib.to(cpu), device=cpu)
    st = env_g.reset(torch.Generator(device=dev).manual_seed(5))
    with torch.no_grad():
        st, _ = env_g.step(st, r.act(env_g.observe(st)))
    o_g = env_g.observe(st).cpu()
    st_c = st.to(cpu).replace(rng=torch.Generator().manual_seed(5))
    o_c = env_c.observe(st_c)
    near = near_edges(env_c, st_c)                       # (N, P)
    errs, listed = obs_errors(small, o_g, o_c, near)
    emit("sensor_paths", path=name, reference_envs=SENSOR_REF_ENVS,
         max_rel_err=errs, tolerance_rel=STEP_RTOL, edge_m=EDGE_M,
         points_near_edges=int(near.sum()), differing_near_edges=listed,
         card=card)
    if not max(errs.values()) <= STEP_RTOL:
        raise SystemExit(f"sensor path {name}: card and CPU observe "
                         f"disagree away from every edge: {errs}")


def sensor_paths(card):
    """The control step at NUM_ENVS for each sensor variant, then each
    variant's card-vs-CPU observe. Returns the launch counts by variant."""
    from emloco_tpu_torch.rollout import SENSOR_VARIANTS, build_bench
    by_path = {}
    per_step = {"cholesky_factor_blocked_t": 1,
                "cholesky_resolve_blocked_t": 2}
    for name, kw in SENSOR_VARIANTS:
        r = build_bench(NUM_ENVS, "cuda", **kw)
        by_path[name], _ = drive_path(r, name, per_step, card,
                                      phase="sensor_paths", env_fields=kw,
                                      obs_dim=r.cfg.obs_dim)
        sensor_reference(r, name, card)
        del r
    return by_path


def timed_epochs(phase, agent, ts, card, setup_s):
    """A warm-up epoch, then CROWD_EPOCHS timed epochs part by part with the
    launch counts read around each. Returns (ts, the first timed epoch's
    first update's inputs, its pools' obs rows, launch counts)."""
    import torch
    from emloco_tpu_torch.physics import linalg
    t = time.time()
    ts, _ = agent.train_epoch(ts)                       # warm-up
    torch.cuda.synchronize()
    warm_s = time.time() - t
    torch.cuda.reset_peak_memory_stats()
    T, N = agent.cfg.horizon, agent.env.cfg.num_envs
    n_sub = agent.env.cfg.engine.n_substeps
    epochs, total, first = [], {}, None
    for _ in range(CROWD_EPOCHS):
        linalg.reset_launch_counts()
        t0 = time.time()
        ts, batch, last_obs = agent.rollout(ts)
        torch.cuda.synchronize()
        t1 = time.time()
        ts, pools = agent.prepare(ts, batch, last_obs)
        torch.cuda.synchronize()
        t2 = time.time()
        before = (ts.params, ts.opt_state, ts.rng.get_state())
        ts, metrics = agent.update(ts, pools)
        metrics = {k: v.item() for k, v in metrics.items()}
        t3 = time.time()
        launches = dict(linalg.LAUNCHES)
        if first is None:
            rows = agent.cfg.amp_batch_size * 5
            first = (first_update(agent, pools, before),
                     pools["data"]["obs_n"][:rows].clone(),
                     pools["data"]["amp_n"][:rows].clone())
        del batch, pools
        epochs.append(dict(rollout_seconds=t1 - t0, prepare_seconds=t2 - t1,
                           update_seconds=t3 - t2, epoch_seconds=t3 - t0,
                           env_steps_per_s=T * N / (t3 - t0),
                           launches=launches, metrics=metrics))
        want = dict.fromkeys(launches, 0)
        want.update({"cholesky_factor_blocked_t": T,
                     "cholesky_resolve_blocked_t": T * n_sub})
        if launches != want:
            raise SystemExit(f"{phase}: launch counts {launches}, "
                             f"expected {want}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    finite = (all(math.isfinite(v) for e in epochs
                  for v in e["metrics"].values())
              and all(bool(torch.isfinite(v).all())
                      for v in ts.params.values()))
    ok = all(e["metrics"]["nonfinite_grad"] == 0
             and e["metrics"]["disc_reward"] < 0.99 * DISC_REWARD_CAP
             and e["metrics"]["d_loss"] > D_LOSS_FLOOR for e in epochs)
    emit(phase, num_envs=N, amp=dataclasses.asdict(agent.cfg),
         env={k: getattr(agent.env.cfg, k) for k in (
             "group_obs", "group_size", "velocity_map", "sensor_shape",
             "sensor_res")},
         obs_dim=agent.env.obs_dim, setup_seconds=round(setup_s, 3),
         warmup_epoch_seconds=warm_s, epochs=epochs,
         env_steps_per_s=CROWD_EPOCHS * T * N
         / sum(e["epoch_seconds"] for e in epochs),
         card=card, finite=finite,
         max_memory_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    if not (finite and ok):
        raise SystemExit(f"{phase} failed: finite {finite}, metrics "
                         f"{[e['metrics'] for e in epochs]} (disc_reward cap "
                         f"{DISC_REWARD_CAP}, d_loss floor {D_LOSS_FLOOR})")
    return ts, first, total


def crowd_train(card):
    """The crowd training epoch (rollout.build_crowd_bench)."""
    import torch
    from emloco_tpu_torch.rollout import build_crowd_bench
    t = time.time()
    agent, ts = build_crowd_bench(TRAIN_ENVS, "cuda", seed=0)
    torch.cuda.synchronize()
    ts, first, launches = timed_epochs("crowd_train", agent, ts, card,
                                       time.time() - t)
    return agent, ts, first[0], launches


def kink_flips(agent, params, mb):
    """Card against CPU, float32, on the update's rows, for each ReLU layer
    and max-pool the loss runs (the actor's and the pointnet's on the obs
    and the mirrored obs, the critic's on the obs): the decisions the two
    devices take the other way (a pre-activation's sign; the person a
    max-pool picks where the two people's features differ), and the
    decisions within 1e-6 of the largest magnitude of a kink on the CPU
    (a pre-activation that near 0, a max-pool's top two that near but not
    equal: equal ones are people zeroed alike)."""
    import torch
    import torch.nn.functional as F
    net = agent.net
    pd, k = net.people_obs_dim, net.pointnet_topk
    heads = {"obs_n": ("actor_mlp", "critic_mlp"),
             "flip_obs_n": ("actor_mlp",)}

    def trace(dev):
        p = {n: v.to(dev) for n, v in params.items()}
        rec = {}
        with torch.no_grad():
            for rows, used in heads.items():
                self_obs, task = net._split(mb[rows].to(dev))
                x = torch.cat([self_obs,
                               agent._apply(p, "task_embed", task)], -1)
                for head in used:
                    h = x
                    for i in range(len(getattr(net, head))):
                        z = F.linear(h, p[f"{head}.{i}.weight"],
                                     p[f"{head}.{i}.bias"])
                        rec[f"{rows}.{head}.{i}"] = z.cpu()
                        h = torch.relu(z)
                people = task[..., -pd:]
                n = people.shape[0]
                q = torch.cat([people[:, :pd - 3 * k].reshape(n, k, -1),
                               people[:, pd - 3 * k:].reshape(n, k, 3)], -1)
                for i in range(3):
                    q = F.linear(q, p[f"point_net.{i}.weight"],
                                 p[f"point_net.{i}.bias"])
                    q = torch.relu(q) if i < 2 else q
                rec[f"{rows}.point_net"] = q.cpu()
        return rec

    card, cpu = trace("cuda"), trace("cpu")
    out = {}
    for name, z in cpu.items():
        eps = 1e-6 * z.abs().max().item()
        if name.endswith("point_net"):
            a, b = card[name].argmax(-2), z.argmax(-2)
            differ = (z.gather(-2, a[:, None]) != z.gather(-2, b[:, None]))
            gap = z.topk(2, dim=-2).values.diff(dim=-2).abs()
            near = (gap > 0) & (gap < eps)          # ties: the same person
            flips = int(((a != b) & differ[:, 0]).sum())
        else:
            near = z.abs() < eps
            flips = int(((card[name] > 0) != (z > 0)).sum())
        out[name] = dict(flips=flips, within_1e6=int(near.sum()))
    return out


def crowd_reference(agent, first):
    """The crowd update on the card against the CPU: in float64 with every
    tolerance of train_reference, then in float32 with its loss terms held
    and its gradients and updates printed beside the count of ReLU and
    max-pool decisions that the two devices take the other way. Those
    kinks, met on a few of the 2,560 rows, are where the float32 gradients
    part: either side is right, and one row's whole contribution moves the
    gradient of its unit's leaf; float64 rounding meets none."""
    import torch
    params, _, mb, *_ = first
    train_reference(agent, first, phase="crowd_reference",
                    dtype=torch.float64)
    train_reference(agent, first, phase="crowd_reference",
                    gated=("loss_rel",))
    emit("crowd_reference", float32_kinks_card_vs_cpu=kink_flips(
        agent, params, mb))


def crowd_query_value_gradient(agent, ts):
    """query_value_gradient on QVG_ENVS envs of the crowd configuration on
    the card and on the CPU with the trained parameters and norm; the CPU
    env observes as the card did (a sensor point at a cell edge may read
    the other side on the other device; sensor_paths holds observe)."""
    import torch
    from emloco_tpu_torch.envs import PedestrianTerrainEnv
    from emloco_tpu_torch.learning.amp_agent import AMPAgent
    cpu = torch.device("cpu")
    small = dataclasses.replace(agent.env.cfg, num_envs=QVG_ENVS)
    env_g = PedestrianTerrainEnv(small, agent.env.terrain,
                                 agent.env.motion_lib, device="cuda")
    env_c = PedestrianTerrainEnv(small, agent.env.terrain.to(cpu),
                                 agent.env.motion_lib.to(cpu), device=cpu)
    st = env_g.reset(torch.Generator(device="cuda").manual_seed(6))
    o_card = env_g.observe(st).cpu()
    env_c.observe = lambda state: o_card
    gen = torch.Generator(device="cuda").manual_seed(7)
    S = small.num_traj_samples
    traj = (st.physics.root_pos[:, None]
            + 1.5 * torch.randn((QVG_ENVS, S, 3), generator=gen,
                                device="cuda"))
    out = {}
    for dev, env, state in (("cuda", env_g, st),
                            ("cpu", env_c, st.to(cpu).replace(
                                rng=torch.Generator()))):
        a = AMPAgent(env, agent.cfg)
        a.net = agent.net
        t = ts.replace(params={k: v.to(dev) for k, v in ts.params.items()},
                       obs_norm=ts.obs_norm.to(dev))
        v, g = a.query_value_gradient(t, state, traj.to(dev))
        out[dev] = (v.cpu(), g.cpu())
    v_err = rel_err(out["cuda"][0], out["cpu"][0])[1]
    g_err = rel_err(out["cuda"][1], out["cpu"][1])[1]
    finite = all(bool(torch.isfinite(x).all()) for x in out["cuda"])
    return dict(envs=QVG_ENVS, value_max_rel_err=v_err,
                grad_max_rel_err=g_err, tolerance_rel=QVG_REL,
                finite=finite,
                grad_nonzero=bool(out["cuda"][1].abs().max() > 0))


def bf16_heads(agent, params, obs_n, amp_n):
    """Every head on the card and on the CPU from the same parameters and
    rows; the largest difference relative to each head's largest |out|."""
    import torch
    errs = {}
    cpu_params = {k: v.cpu() for k, v in params.items()}
    with torch.no_grad():
        for head, x in (("actor", obs_n), ("critic", obs_n), ("disc", amp_n),
                        ("task_value", obs_n)):
            g = agent._apply(params, head, x)
            c = agent._apply(cpu_params, head, x.cpu())
            g = g[0] if head == "actor" else g
            c = c[0] if head == "actor" else c
            errs[head] = rel_err(g.cpu(), c)[1]
    return errs


def bf16_train(card):
    """The hidden_bf16 training epoch at the bench's training
    configuration, then its heads on the card against the CPU."""
    import torch
    from emloco_tpu_torch.rollout import TRAIN_AMP, build_train_bench
    t = time.time()
    agent, ts = build_train_bench(
        TRAIN_ENVS, "cuda", 0, dataclasses.replace(TRAIN_AMP,
                                                   hidden_bf16=True))
    torch.cuda.synchronize()
    ts, (_, obs_n, amp_n), launches = timed_epochs(
        "bf16_train", agent, ts, card, time.time() - t)
    errs = bf16_heads(agent, ts.params, obs_n, amp_n)
    emit("bf16_train", heads_card_vs_cpu=errs, rows=int(obs_n.shape[0]),
         tolerance_rel=BF16_HEAD_REL)
    if not max(errs.values()) <= BF16_HEAD_REL:
        raise SystemExit(f"bf16_train: heads disagree between the card and "
                         f"the CPU: {errs}")
    return launches


def perturbations(card):
    """PERTURB_STEPS control steps at TRAIN_ENVS envs with every
    perturbation and hard-negative sampling, the kicks recorded; then the
    refresh and the demo fetch."""
    import torch
    from emloco_tpu_torch.envs import pedestrian_terrain as pt
    from emloco_tpu_torch.physics import linalg
    from emloco_tpu_torch.rollout import build_bench
    r = build_bench(TRAIN_ENVS, "cuda", **PERTURB)
    env, cfg = r.env, r.cfg
    log = {"push": [], "projectile": [], "perturb": []}
    inner = {n: getattr(pt, n) for n in ("push_draw", "projectile_draw")}
    perturb = env._perturb

    def rec(name):
        def f(*args):
            out = inner[name](*args)
            log[name.split("_")[0]].append(out)
            return out
        return f

    def rec_perturb(physics, progress, gen):
        out = perturb(physics, progress, gen)
        log["perturb"].append((physics.u.clone(), out.u.clone(),
                               physics.body_x.clone(), progress.clone()))
        return out

    state = env.reset(torch.Generator(device="cuda").manual_seed(8))
    dones = 0
    finite = True
    torch.cuda.synchronize()
    linalg.reset_launch_counts()
    t = time.time()
    try:
        for name in inner:
            setattr(pt, name, rec(name))
        env._perturb = rec_perturb
        for _ in range(PERTURB_STEPS):
            state, out, o, mu = r.control_step(state)
            dones += int(out.done.sum())
            finite &= bool(torch.isfinite(out.obs).all()
                           and torch.isfinite(state.physics.u).all())
    finally:
        for name, fn in inner.items():
            setattr(pt, name, fn)
        del env._perturb
    torch.cuda.synchronize()
    dt = time.time() - t
    launches = dict(linalg.LAUNCHES)
    # each step's kick, computed here from its draws
    mass = env.params.mass.sum(-1, keepdim=True)
    kick_err, untouched_ok, n_push, n_hit = 0.0, True, 0, 0
    lift = torch.tensor([1.0, 1.0, 0.2], device="cuda")
    flat = torch.tensor([1.0, 1.0, 0.3], device="cuda")
    for (u0, u1, bx, prog), raw, (body, d) in zip(
            log["perturb"], log["push"], log["projectile"]):
        push = prog % cfg.push_interval == cfg.push_interval - 1
        hit = prog % cfg.projectile_interval == cfg.projectile_interval - 1
        want = torch.zeros_like(u0)
        want[:, 0:3] += push[:, None] * cfg.push_vel * raw * lift
        dd = d * flat
        imp = cfg.projectile_impulse * dd / (dd.norm(dim=-1, keepdim=True)
                                             + 1e-8)
        lever = bx[torch.arange(bx.shape[0], device="cuda"), body] - bx[:, 0]
        want[:, 0:3] += hit[:, None] * imp / mass
        want[:, 3:6] += hit[:, None] * torch.linalg.cross(lever, imp) / (
            mass * 0.15)
        touched = push | hit
        if bool(touched.any()):
            got = (u1 - u0)[touched]
            scale = max(u1.abs().max().item(), 1.0)
            kick_err = max(kick_err, (got - want[touched]).abs().max().item()
                           / scale)
        untouched_ok &= bool(torch.equal(u1[~touched], u0[~touched]))
        n_push += int(push.sum())
        n_hit += int(hit.sum())
    sampled = state.motion_sampled.sum().item()
    state = env.apply_hard_negative_update(state)
    w = state.motion_weights
    n_demo = 200_000
    mids, _ = env.sample_amp_demo(torch.Generator(device="cuda").manual_seed(9),
                                  n_demo, motion_weights=w)
    freq = torch.bincount(mids, minlength=w.shape[0]).double() / n_demo
    sigma = (w.double() * (1 - w.double()) / n_demo).sqrt()
    demo_ok = bool(((freq - w.double()).abs() <= 5 * sigma + 1e-4).all())
    w_sum = w.sum().item()
    finite &= bool(torch.isfinite(w).all())
    emit("perturbations", num_envs=TRAIN_ENVS, steps=PERTURB_STEPS,
         env=PERTURB, seconds=dt, env_steps_per_s=TRAIN_ENVS
         * PERTURB_STEPS / dt, card=card, launches=launches,
         pushed=n_push, hit=n_hit, kick_max_rel_err=kick_err,
         untouched_unchanged=untouched_ok, dones=dones,
         motion_sampled=sampled, weights=w.tolist(), weights_sum=w_sum,
         demo_freq=freq.tolist(), demo_ok=demo_ok, finite=finite)
    want = dict.fromkeys(launches, 0)
    want.update({"cholesky_factor_blocked_t": PERTURB_STEPS,
                 "cholesky_resolve_blocked_t":
                     PERTURB_STEPS * cfg.engine.n_substeps})
    if launches != want:
        raise SystemExit(f"perturbations: launch counts {launches}, "
                         f"expected {want}")
    if not (finite and n_push and n_hit and kick_err <= 2.0 ** -20
            and untouched_ok and sampled == dones and dones > 0
            and abs(w_sum - 1.0) <= 1e-6 and demo_ok):
        raise SystemExit(
            f"perturbations failed: finite {finite}, pushed {n_push}, hit "
            f"{n_hit}, kick error {kick_err}, untouched {untouched_ok}, "
            f"sampled {sampled} vs dones {dones}, weights sum {w_sum}, "
            f"demo {freq.tolist()} vs {w.tolist()}")
    return launches


def merged_rows(engine):
    """The merged row count M of an engine configuration: 72 body and 72
    inertia rows, 4 rows a ground point (3 point rows and a normal row), 4
    a self pair."""
    from emloco_tpu_torch.physics import reduced as R
    ground = R.NC_MESH if engine.mesh_contacts else R.NC
    return 2 * R.MROWS + 4 * ground + (4 * R.NSELF if engine.self_contact
                                       else 0)


def contact_paths(rollout, card):
    """The control step at NUM_ENVS under each of CONTACT_PATHS, with the
    rows gram_diag gets on its first call (the warm-up step) recorded for
    the gram variants. Returns (launch counts by path, {name: (R, w,
    d)})."""
    from emloco_tpu_torch.physics import EngineConfig
    from emloco_tpu_torch.physics import reduced as R
    from emloco_tpu_torch.rollout import smpl_params
    by_path, rows = {}, {}
    inner = R.gram_diag
    for name, kw, smpl, per_step in CONTACT_PATHS:
        engine = EngineConfig(**kw)
        params = smpl_params(NUM_ENVS, "cuda") if smpl else None
        r = rollout.with_engine(engine, params)
        seen = []

        def rec(Rr, w, d, out_rows=None, _seen=seen):
            if not _seen:
                _seen.append((Rr.clone(), w.clone(), d.clone()))
            return inner(Rr, w, d, out_rows=out_rows)

        def after(state, _r=r):
            ph = state.physics
            pen = R._self_contact_geometry(_r.env.model, ph.body_x,
                                           ph.body_q)[3]
            return dict(self_pairs_penetrating=int((pen > 0).sum()))

        R.gram_diag = rec
        try:
            by_path[f"contact_{name}"], _ = drive_path(
                r, name, per_step, card, phase="contact_paths", after=after,
                engine=kw, smpl_colliders=smpl,
                merged_rows=merged_rows(engine))
        finally:
            R.gram_diag = inner
        if kw.get("gram_kernel"):
            rows[name] = seen[0]
        del r, params
    return by_path, rows


def contact_kernels(rows, card):
    """gram_diag against its plain version on the recorded rows of each
    gram variant, bit for bit (gram_kernels), and its time at each M with
    its bound as gram_times computes it. Returns the max abs error."""
    worst = gram_kernels({f"{k}_M{v[0].shape[1]}": v
                          for k, v in rows.items()}, phase="contact_kernels")
    for name, (Rr, w, d) in rows.items():
        t, (nb, nf, pk) = gram_times(Rr, w, d)
        bound_ms = max(nb / HBM_BYTES_S, nf / pk) * 1e3
        emit("contact_kernels", case=name, num_envs=int(Rr.shape[0]),
             rows=int(Rr.shape[1]), dtype=str(Rr.dtype), card=card, **t,
             bound_ms=bound_ms, bound_share=bound_ms / t["ms"], bytes=nb,
             flops=nf, flop_peak=pk)
    return worst


def folded_arm(env, state):
    """`state` with every env standing at its spawn in the rest pose, the
    left forearm folded into the torso (shoulder exp-map (−2.2, 0, 0),
    elbow (0, 1.2, 0), as tests/test_engine.py:344-355): the L_Elbow/Torso
    pair interpenetrates."""
    import torch
    from emloco_tpu_torch.kinematics import body_model as bm
    from emloco_tpu_torch.ops import quat
    from emloco_tpu_torch.physics import height_at, kinematic_state
    ph = state.physics
    n, dev = ph.root_pos.shape[0], ph.root_pos.device
    loc = quat.identity_like((n, bm.NUM_BODIES), device=dev)
    for body, e in (("L_Shoulder", (-2.2, 0.0, 0.0)),
                    ("L_Elbow", (0.0, 1.2, 0.0))):
        loc[:, bm.BODY_NAMES.index(body)] = quat.exp_map_to_quat(
            torch.tensor(e, device=dev))
    xy = ph.root_pos[:, :2]
    z = height_at(env.terrain, xy) + env.params.height_offset
    return state.replace(physics=kinematic_state(
        env.model, env.tree, torch.cat([xy, z[:, None]], -1),
        quat.identity_like((n,), device=dev), loc))


def reference_contacts(cfg, env, gen):
    """card_vs_cpu from the folded-arm pose for each CONTACT_REFERENCES
    configuration; with self-contact the CPU's first contact build must
    find an interpenetrating pair."""
    from emloco_tpu_torch.physics import EngineConfig
    for kw in CONTACT_REFERENCES:
        calls = card_vs_cpu(
            "reference_contacts",
            dataclasses.replace(cfg, engine=EngineConfig(**kw)), env, gen,
            start=folded_arm, engine=kw)
        act, _, ng = calls[1][0]
        if kw.get("self_contact") and not bool(act[:, ng:].any()):
            raise SystemExit(f"reference_contacts {kw}: no self pair "
                             "interpenetrates in the folded-arm pose")


def epoch_kernels(engine, T):
    """Kernel launches of a training epoch of T control steps: the dense
    solve 2 a step where self-contact pairs leave the block-arrow pattern,
    else the factor 1 and the resolve 2."""
    from emloco_tpu_torch.physics import reduced as R
    n = engine.n_substeps
    if not R._arrow_exact(engine):
        return {"cholesky_solve_soa_t": T * n}
    return {"cholesky_factor_blocked_t": T,
            "cholesky_resolve_blocked_t": T * n}


def task_epochs(phase, agent, ts, card, schedules=False, **extra):
    """A warm-up and a timed epoch part by part with the launch counts read
    around each, with the getup schedules applied at each epoch's number
    where `schedules`; fails unless each epoch's counts are epoch_kernels,
    everything is finite, no gradient was nonfinite and the parameters
    moved. Returns the epochs' records."""
    import torch
    from emloco_tpu_torch.physics import linalg
    env = agent.env
    T, N = agent.cfg.horizon, env.cfg.num_envs
    p_init = {k: v.clone() for k, v in ts.params.items()}
    epochs = []
    torch.cuda.reset_peak_memory_stats()
    for ep in range(2):
        if schedules:
            upd = env.cfg.getup_update_epoch
            ts = ts.replace(env_state=env.update_getup_schedule(
                ts.env_state, ts.epoch, upd))
            ts = agent.update_getup_reward_schedule(ts, ts.epoch, upd)
        linalg.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        ts, batch, last_obs = agent.rollout(ts)
        torch.cuda.synchronize()
        t1 = time.time()
        ts, pools = agent.prepare(ts, batch, last_obs)
        torch.cuda.synchronize()
        t2 = time.time()
        ts, metrics = agent.update(ts, pools)
        metrics = {k: v.item() for k, v in metrics.items()}
        t3 = time.time()
        launches = dict(linalg.LAUNCHES)
        rec = dict(warmup=ep == 0, rollout_seconds=t1 - t0,
                   prepare_seconds=t2 - t1, update_seconds=t3 - t2,
                   epoch_seconds=t3 - t0, env_steps_per_s=T * N / (t3 - t0),
                   launches=launches, metrics=metrics,
                   dones=int(batch["done"].sum()),
                   terminations=int(batch["terminated"].sum()),
                   task_reward_w=ts.task_reward_w.item(),
                   disc_reward_w=ts.disc_reward_w.item())
        if schedules:
            st = ts.env_state
            rec.update(fall_init_prob=st.fall_init_prob.item(),
                       recovery_episode_prob=st.recovery_episode_prob.item(),
                       recovering=int((st.recovery_counter > 0).sum()))
        epochs.append(rec)
        del batch, pools
        want = dict.fromkeys(launches, 0)
        want.update(epoch_kernels(env.cfg.engine, T))
        if launches != want:
            raise SystemExit(f"{phase}: launch counts {launches}, "
                             f"expected {want}")
    finite = (all(math.isfinite(v) for e in epochs
                  for v in e["metrics"].values())
              and all(bool(torch.isfinite(v).all())
                      for v in ts.params.values()))
    moved = any(not torch.equal(ts.params[k], p_init[k]) for k in p_init)
    nonfinite = sum(e["metrics"]["nonfinite_grad"] for e in epochs)
    emit(phase, num_envs=N, amp=dataclasses.asdict(agent.cfg),
         engine=dataclasses.asdict(env.cfg.engine), obs_dim=env.obs_dim,
         epochs=epochs, env_steps_per_s=epochs[-1]["env_steps_per_s"],
         card=card, finite=finite, params_moved=moved,
         max_memory_gb=torch.cuda.max_memory_allocated() / 2 ** 30, **extra)
    if not (finite and moved and nonfinite == 0):
        raise SystemExit(f"{phase} failed: finite {finite}, moved {moved}, "
                         f"nonfinite_grad {nonfinite}")
    return epochs


def getup_train(card):
    """The getup training configuration: the fall bank generated again and
    timed, then task_epochs with both schedules. Returns the timed epoch's
    launch counts."""
    import torch
    from emloco_tpu_torch.physics import height_at
    from emloco_tpu_torch.physics import reduced as R
    from emloco_tpu_torch.rollout import build_getup_bench
    t = time.time()
    agent, ts = build_getup_bench(TRAIN_ENVS, "cuda", seed=0)
    torch.cuda.synchronize()
    setup_s = time.time() - t
    env = agent.env
    t = time.time()
    bank = env._generate_fall_states(
        torch.Generator(device="cuda").manual_seed(1234))
    torch.cuda.synchronize()
    bank_s = time.time() - t
    fields = [f.name for f in dataclasses.fields(bank)]
    h = bank.root_pos[:, 2] - height_at(env.terrain, bank.root_pos[:, :2])
    pts, radius, _ = R._ground_geometry(env.model, bank.body_x, bank.body_q,
                                        env.cfg.engine)
    clear = pts[..., 2] - radius - height_at(env.terrain, pts[..., :2])
    force = bank.contact_force.norm(dim=-1).sum(-1)
    steps = env.cfg.fall_gen_steps // env.cfg.engine.n_substeps
    stats = dict(
        control_steps=steps, seconds=bank_s,
        env_steps_per_s=TRAIN_ENVS * steps / bank_s,
        finite=all(bool(torch.isfinite(getattr(bank, f)).all())
                   for f in fields),
        regenerated_bit_equal=all(torch.equal(getattr(bank, f),
                                              getattr(env.fall_bank, f))
                                  for f in fields),
        root_height_min=h.min().item(), root_height_median=h.median().item(),
        root_height_max=h.max().item(),
        collider_clearance_min=clear.min().item(),
        ground_share=(force > GROUND_FORCE_N).float().mean().item())
    del bank
    epochs = task_epochs("getup_train", agent, ts, card, schedules=True,
                         setup_seconds=setup_s, fall_bank=stats)
    dones = sum(e["dones"] for e in epochs)
    recovering = max(e["recovering"] for e in epochs)
    if not (stats["finite"] and 0 < stats["root_height_median"] < DROP_M
            and stats["ground_share"] >= GROUND_SHARE and dones > 0
            and recovering > 0):
        raise SystemExit(f"getup_train failed: fall bank {stats}, fall "
                         f"resets {dones}, recovering envs {recovering}")
    return epochs[-1]["launches"]


def hand_train(card):
    """The hand task's training configuration through task_epochs; its
    observation is the terrain env's and the two hand targets. Returns the
    timed epoch's launch counts."""
    import torch
    from emloco_tpu_torch.rollout import build_hand_bench
    t = time.time()
    agent, ts = build_hand_bench(TRAIN_ENVS, "cuda", seed=0)
    torch.cuda.synchronize()
    env = agent.env
    epochs = task_epochs("hand_train", agent, ts, card,
                         setup_seconds=time.time() - t,
                         terrain_obs_dim=env.cfg.obs_dim)
    if env.obs_dim != env.cfg.obs_dim + 2:
        raise SystemExit(f"hand_train: obs_dim {env.obs_dim}, expected "
                         f"{env.cfg.obs_dim} + 2")
    return epochs[-1]["launches"]


# ---------------------------------------------------------------------------
# 29-33: policy checkpoints and the trajectory predictor
# ---------------------------------------------------------------------------

def zero_launches(phase, launches):
    """The predictor phases launch none of the engine's kernels."""
    if any(launches.values()):
        raise SystemExit(f"{phase}: launched engine kernels {launches}")


def policy_checkpoint(card):
    """One training epoch at the bench's training configuration, saved as a
    policy file and read into a fresh agent: the deterministic action on
    the same observation, the three norms and the Adam state bit-equal;
    then train_value --policy for one epoch. Returns the launch counts."""
    import tempfile

    import torch
    from emloco_tpu_torch import train_value
    from emloco_tpu_torch.learning.amp_agent import AMPAgent
    from emloco_tpu_torch.physics import linalg
    from emloco_tpu_torch.rollout import build_train_bench
    from emloco_tpu_torch.utils import checkpoint as ckpt
    linalg.reset_launch_counts()
    t = time.time()
    agent, ts = build_train_bench(TRAIN_ENVS, "cuda", seed=0)
    ts, _ = agent.train_epoch(ts)
    torch.cuda.synchronize()
    epoch_s = time.time() - t
    with tempfile.TemporaryDirectory() as out:
        path = os.path.join(out, "policy_00000000.ckpt")
        t = time.time()
        ckpt.save_policy(path, ts, 0)
        tree, meta = ckpt.load_pytree(path)
        fresh = AMPAgent(agent.env, agent.cfg)
        back = ckpt.restore_policy(fresh.init(1), tree)
        io_s = time.time() - t
        size_mb = os.path.getsize(path) / 2 ** 20
        obs = agent.env.observe(ts.env_state)

        def act(a, s):
            with torch.no_grad():
                return a._apply(s.params, "actor", s.obs_norm.normalize(obs))[0]

        same = dict(
            action=bool(torch.equal(act(agent, ts), act(fresh, back))),
            norms=all(torch.equal(getattr(getattr(ts, n), f),
                                  getattr(getattr(back, n), f))
                      for n in ("obs_norm", "amp_norm", "value_norm")
                      for f in ("mean", "var", "count")),
            adam=bool(torch.equal(ts.opt_state.count, back.opt_state.count))
            and all(torch.equal(ts.opt_state.mu[k], back.opt_state.mu[k])
                    and torch.equal(ts.opt_state.nu[k], back.opt_state.nu[k])
                    for k in ts.params),
            params=all(torch.equal(ts.params[k], back.params[k])
                       for k in ts.params))
        del agent, fresh, back
        buf = io.StringIO()
        t = time.time()
        with contextlib.redirect_stdout(buf):
            vts = train_value.main(["--policy", path, "--epochs", "1",
                                    "--out", out])
        value_s = time.time() - t
        line = json.loads(buf.getvalue().splitlines()[-1])
        policy_same = all(torch.equal(vts.policy.params[k], ts.params[k])
                          for k in ts.params)
        del vts
    launches = dict(linalg.LAUNCHES)
    finite = all(math.isfinite(v) for v in line.values()
                 if isinstance(v, float))
    # the training epoch and the LocoVal epoch: 32 control steps each
    want = dict.fromkeys(launches, 0)
    want.update({"cholesky_factor_blocked_t": 64,
                 "cholesky_resolve_blocked_t": 128})
    emit("policy_checkpoint", card=card, num_envs=TRAIN_ENVS,
         epoch_seconds=epoch_s, save_load_seconds=io_s, file_mb=size_mb,
         metadata=meta, bit_equal=same, train_value=line,
         train_value_seconds=value_s, train_value_policy_loaded=policy_same,
         launches=launches)
    if not (all(same.values()) and policy_same and finite
            and launches == want):
        raise SystemExit(f"policy_checkpoint failed: bit-equal {same}, "
                         f"train_value policy {policy_same}, line {line}, "
                         f"launches {launches} (expected {want})")
    return launches


def predictor_setup():
    """The jta preset at full width on the card, the frozen LocoVal net from
    PRED_VNET_SEED and its state_dict on the CPU, and the synthetic scenes
    of 4 people."""
    import torch
    from emloco_tpu_torch.learning import ValuePoseNet
    from emloco_tpu_torch.prediction.data import SyntheticScenes
    from emloco_tpu_torch.prediction.presets import configs
    from emloco_tpu_torch.prediction.train import PredictorTrainer
    mcfg, pcfg = configs("jta")
    vnet = ValuePoseNet(generator=torch.Generator().manual_seed(
        PRED_VNET_SEED), device="cpu")
    vp = {k: v.detach().clone() for k, v in vnet.named_parameters()}
    trainer = PredictorTrainer(mcfg, pcfg,
                               vnet=ValuePoseNet(device="cuda"),
                               device="cuda")
    return trainer, vp, SyntheticScenes(num_people=4, seed=0)


def predictor_train(card, trainer, vp, scenes):
    """One epoch of the CLI's defaults (20 steps of batch 10) with the
    EmLoco loss: losses finite, parameters moved, the LocoVal parameters
    bit-equal, the value loss nonzero with a nonzero gradient at the heads.
    Returns the state after the epoch and one more batch."""
    import torch
    from torch.func import functional_call
    from emloco_tpu_torch.learning import fused_adam
    from emloco_tpu_torch.physics import linalg
    from emloco_tpu_torch.prediction.data import OBS_FRAMES
    mcfg = trainer.mcfg
    ts = trainer.init(0, vnet_params=vp)
    p0 = {k: v.clone() for k, v in ts.params.items()}
    vp0 = {k: v.clone() for k, v in ts.vnet_params.items()}
    t = time.time()
    batches = list(scenes.batches(PRED_BATCH, PRED_STEPS + 2))
    data_s = time.time() - t
    ts, _ = trainer.train_step(ts, *batches[0])         # warm-up
    torch.cuda.synchronize()
    linalg.reset_launch_counts()
    fused_adam.reset_launch_counts()
    t = time.time()
    aux = []
    for b in batches[1:PRED_STEPS + 1]:
        ts, a = trainer.train_step(ts, *b)
        aux.append(a)
    torch.cuda.synchronize()
    dt = time.time() - t
    launches = dict(linalg.LAUNCHES)
    fused = fused_adam.LAUNCHES["clip_adam"]
    aux = {k: [a[k].item() for a in aux] for k in aux[0]}
    finite = all(math.isfinite(v) for vals in aux.values() for v in vals)
    moved = any(not torch.equal(ts.params[k], p0[k]) for k in p0)
    frozen = all(torch.equal(ts.vnet_params[k], vp0[k]) for k in vp0)
    # the value loss alone and its gradient at the heads
    obs, mask, _, pose, vel = trainer.tensors(batches[-1])
    pose = pose * torch.tensor([1.0, 1.0, -1.0], device="cuda")
    p = {k: v.detach().requires_grad_(k.startswith("heads."))
         for k, v in ts.params.items()}
    with torch.enable_grad():
        out = functional_call(trainer.model, p, (obs, mask))
        vloss = trainer._value_loss(ts.vnet_params, out[:, OBS_FRAMES:],
                                    pose, vel)
        g, = torch.autograd.grad(vloss, p["heads.weight"])
    heads_grad = g.abs().max().item()
    n_params = sum(v.numel() for v in ts.params.values())
    emit("predictor_train", card=card, preset="jta",
         model=dataclasses.asdict(mcfg),
         train=dataclasses.asdict(trainer.cfg), parameters=n_params,
         local_tokens=mcfg.total_frames + mcfg.obs_frames * (
             2 + mcfg.num_3dpose + mcfg.num_2dpose),
         batch=PRED_BATCH, people=scenes.num_people, steps=PRED_STEPS,
         seconds=dt, steps_per_s=PRED_STEPS / dt,
         step_ms=dt / PRED_STEPS * 1e3, data_seconds=data_s,
         traj_loss=aux["traj_loss"], value_loss=aux["value_loss"],
         total=aux["total"], finite=finite, params_moved=moved,
         locoval_bit_equal=frozen, value_loss_alone=vloss.item(),
         heads_grad_max_abs=heads_grad, launches=launches,
         fused_optimizer_steps=fused, max_memory_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    zero_launches("predictor_train", launches)
    if fused != PRED_STEPS:
        raise SystemExit(f"predictor_train: {fused} fused optimizer steps, "
                         f"expected {PRED_STEPS}")
    if not (finite and moved and frozen and min(aux["value_loss"]) > 0
            and vloss.item() > 0 and heads_grad > 0):
        raise SystemExit(
            f"predictor_train failed: finite {finite}, moved {moved}, "
            f"LocoVal bit-equal {frozen}, value loss {aux['value_loss']}, "
            f"heads gradient {heads_grad}")
    return ts, batches[-1], launches


def cast(x, dev, dtype):
    """A tensor on `dev`, in `dtype` if it is floating point."""
    return x.to(dev, dtype) if x.is_floating_point() else x.to(dev)


def ff_kinks(card, cpu):
    """Card against CPU, for each encoder layer's FF pre-activations
    (`ff1`'s output, before the ReLU) of one train step: the units whose
    sign the two devices take the other way, and the units within 1e-6 of
    the layer's largest |pre-activation| on the CPU."""
    out = {}
    for name, z in cpu.items():
        eps = 1e-6 * z.abs().max().item()
        out[name] = dict(flips=int(((card[name] > 0) != (z > 0)).sum()),
                         within_1e6=int((z.abs() < eps).sum()),
                         units=z.numel())
    return out


def predictor_step(trainer, cpu_tr, ts, batch, vp, dtype, record=False):
    """One train step (dropout on, the draws made on the CPU) in `dtype` on
    the card and on the CPU from the same state and batch: by device its
    seconds, loss terms, gradients and updated parameters on the CPU, and
    with `record` each encoder layer's FF pre-activations."""
    import torch
    from emloco_tpu_torch.prediction.data import SceneBatch
    runs = {}
    for dev, tr in (("cuda", trainer), ("cpu", cpu_tr)):
        def to(x):
            return cast(x, dev, dtype)
        s = ts.replace(params={k: to(v) for k, v in ts.params.items()},
                       opt_state=ts.opt_state.map_tensors(to),
                       vnet_params={k: to(v) for k, v in vp.items()},
                       rng=torch.Generator().manual_seed(PRED_REF_SEED))
        b = SceneBatch(*(to(x) for x in tr.tensors(batch)))
        ff = {}
        hooks = [m.register_forward_hook(
                     lambda m, i, o, n=n, ff=ff:
                     ff.__setitem__(n, o.detach().cpu()))
                 for n, m in tr.model.named_modules()
                 if record and n.endswith("ff1")]
        t = time.time()
        try:
            total, aux, grads = tr.loss_and_grads(s, *b)
            p1, _ = tr.tx.update(grads, s.opt_state, s.params)
        finally:
            for h in hooks:
                h.remove()
        seconds = time.time() - t
        runs[dev] = dict(seconds=seconds,
                         terms={k: v.item() for k, v in
                                {**aux, "total": total}.items()},
                         grads={k: v.cpu() for k, v in grads.items()},
                         params={k: v.cpu() for k, v in p1.items()}, ff=ff)
    return runs


def predictor_reference(trainer, ts, batch, vp):
    """One full-width train step on the card against the CPU: in float64
    with train_reference's gates; then in float32, the step the main path
    runs, with its loss terms held and its gradients and updates printed
    beside the count of FF ReLU decisions that the two devices take the
    other way. Those kinks, among 40·453·1,024 units a local layer, are
    where the float32 gradients part (PR 14's crowd update parts at its
    ReLU and max-pool kinks alike); float64 rounding meets none. Then
    eval-mode predict in float32."""
    import torch
    from emloco_tpu_torch.learning import ValuePoseNet
    from emloco_tpu_torch.prediction.train import PredictorTrainer
    cpu_tr = PredictorTrainer(trainer.mcfg, trainer.cfg,
                              vnet=ValuePoseNet(device="cpu"), device="cpu")
    tol = dict(loss_rel=LOSS_REL, grad_rel=GRAD_REL, step_lr=UPDATE_LR,
               update_lr=UPDATE_LR)
    for dtype, gated in ((torch.float64, tuple(tol)),
                         (torch.float32, ("loss_rel",))):
        runs = predictor_step(trainer, cpu_tr, ts, batch, vp, dtype,
                              record=dtype == torch.float32)
        card, cpu = runs["cuda"], runs["cpu"]
        opt_cpu = ts.opt_state.map_tensors(lambda x: cast(x, "cpu", dtype))
        p0 = {k: cast(v, "cpu", dtype) for k, v in ts.params.items()}
        step_ref, _ = cpu_tr.tx.update(card["grads"], opt_cpu, p0)
        lr_t = cpu_tr.tx.learning_rate(opt_cpu.count).item()
        top = max(g.abs().max().item() for g in cpu["grads"].values())
        term_err = {k: abs(card["terms"][k] - v) / max(abs(v), 1e-6)
                    for k, v in cpu["terms"].items()}
        grad_err, step_err, update_err = {}, {}, {}
        for k, g in cpu["grads"].items():
            # the key projections' bias gradients are zero (the softmax
            # over keys ignores a common shift): rounding, held to the
            # largest |g|
            scale = max(top if k.endswith("attn.key.bias")
                        else g.abs().max().item(), 1e-30)
            grad_err[k] = (card["grads"][k] - g).abs().max().item() / scale
            step_err[k] = (card["params"][k] - step_ref[k]).abs().max() \
                .item() / lr_t
            clear = g.abs() >= GRAD_REL * scale
            du = card["params"][k] - cpu["params"][k]
            update_err[k] = (du[clear].abs().max().item() / lr_t
                             if bool(clear.any()) else 0.0)
        worst = dict(loss_rel=max(term_err.values()),
                     grad_rel=max(grad_err.values()),
                     step_lr=max(step_err.values()),
                     update_lr=max(update_err.values()))
        precision = str(dtype).split(".")[-1]
        kinks = ff_kinks(card["ff"], cpu["ff"]) if card["ff"] else None
        emit("predictor_reference", precision=precision, batch=PRED_BATCH,
             lr_t=lr_t, count=int(opt_cpu.count),
             card_seconds=card["seconds"], cpu_seconds=cpu["seconds"],
             terms_card=card["terms"], terms_cpu=cpu["terms"], worst=worst,
             tolerance=tol, gated=gated, grad_rel_by_leaf=grad_err,
             ff_kinks_card_vs_cpu=kinks,
             ff_flips=(sum(v["flips"] for v in kinks.values())
                       if kinks else None))
        finite = all(math.isfinite(v) for r in (card, cpu)
                     for v in r["terms"].values())
        if not (finite and all(worst[k] <= tol[k] for k in gated)):
            raise SystemExit(f"predictor_reference: the card's {precision} "
                             f"step disagrees with the CPU's: {worst}")
    b = trainer.tensors(batch)
    pred = {dev: tr.predict({k: v.to(dev) for k, v in ts.params.items()},
                            b.obs, b.padding_mask).cpu()
            for dev, tr in (("cuda", trainer), ("cpu", cpu_tr))}
    pred_err = ((pred["cuda"] - pred["cpu"]).abs().max().item()
                / max(pred["cpu"].abs().max().item(), 1e-30))
    emit("predictor_reference", precision="float32", predict_rel=pred_err,
         tolerance=PRED_PREDICT_REL)
    if not pred_err <= PRED_PREDICT_REL:
        raise SystemExit(f"predictor_reference: the card's predict disagrees "
                         f"with the CPU's: {pred_err}")


def predictor_eval(card, trainer, ts, vp):
    """evaluate_with_filter at threshold 0.7 on the JTA fixture's windows,
    PRED_EVAL_BATCHES batches on the card, timed; then both sweeps; then the
    same calls on the card and on the CPU on fewer batches of the same
    windows at the same padding (the fixture holds 4 windows, which every
    batch of 10 draws again), each metric within 1e-4 of its magnitude. At
    a threshold where a mode within 1e-5 of it is kept on one device only,
    that threshold's filtered minima are excused and its kept_frac may
    differ by at most two modes a flip (the mode and the argmax
    fallback)."""
    import numpy as np
    import torch
    from emloco_tpu_torch.learning import ValuePoseNet
    from emloco_tpu_torch.physics import linalg
    from emloco_tpu_torch.prediction import evaluate as ev
    from emloco_tpu_torch.prediction.data import NdjsonScenes
    from emloco_tpu_torch.prediction.train import PredictorTrainer
    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "data", "jta_all_cues_fixture.ndjson")
    zf = trainer.cfg.pose_z_flip
    cpu_tr = PredictorTrainer(trainer.mcfg, trainer.cfg, device="cpu")
    setups = {"cuda": (trainer, ts.params, {k: v.to("cuda")
                                            for k, v in vp.items()}),
              "cpu": (cpu_tr, {k: v.cpu() for k, v in ts.params.items()},
                      vp)}
    vnets = {d: ValuePoseNet(device=d) for d in setups}

    def data():
        return NdjsonScenes(fixture, seed=PRED_EVAL_SEED)

    linalg.reset_launch_counts()
    tr, params, vpc = setups["cuda"]
    ev.evaluate_with_filter(tr, params, data(), PRED_BATCH, 1,
                            vnet=vnets["cuda"], vnet_params=vpc,
                            pose_z_flip=zf)                  # warm-up
    torch.cuda.synchronize()
    t = time.time()
    full = ev.evaluate_with_filter(tr, params, data(), PRED_BATCH,
                                   PRED_EVAL_BATCHES, vnet=vnets["cuda"],
                                   vnet_params=vpc, threshold=0.7,
                                   pose_z_flip=zf)
    dt = time.time() - t
    t = time.time()
    sweep = ev.filter_threshold_sweep(tr, params, data(), PRED_BATCH,
                                      PRED_EVAL_BATCHES, vnets["cuda"], vpc,
                                      pose_z_flip=zf)
    sweep_s = time.time() - t
    t = time.time()
    lengths = ev.observation_length_sweep(tr, params, data(), PRED_BATCH,
                                          PRED_EVAL_BATCHES)
    lengths_s = time.time() - t
    launches = dict(linalg.LAUNCHES)
    emit("predictor_eval", card=card, batch=PRED_BATCH,
         batches=PRED_EVAL_BATCHES, windows=len(data()), threshold=0.7,
         seconds=dt, scenes_per_s=PRED_BATCH * PRED_EVAL_BATCHES / dt,
         evaluate=full, threshold_sweep=sweep, threshold_sweep_seconds=sweep_s,
         obs_length_sweep=lengths, obs_length_sweep_seconds=lengths_s,
         launches=launches)
    zero_launches("predictor_eval", launches)

    res = {}
    for dev, (tr, params, vpc) in setups.items():
        t = time.time()
        res[dev] = dict(evaluate=ev.evaluate_with_filter(
            tr, params, data(), PRED_BATCH, PRED_REF_BATCHES,
            vnet=vnets[dev], vnet_params=vpc, threshold=0.7, pose_z_flip=zf),
            sweep=ev.filter_threshold_sweep(
                tr, params, data(), PRED_BATCH, PRED_REF_BATCHES,
                vnets[dev], vpc, pose_z_flip=zf),
            lengths=ev.observation_length_sweep(
                tr, params, data(), PRED_BATCH, PRED_REF_LENGTH_BATCHES),
            seconds=time.time() - t)

    def values(dev):
        tr, params, vpc = setups[dev]
        return np.concatenate([
            ev.batch_eval(tr, params, b, vnets[dev], vpc, 0.7, zf)["values"]
            for b in data().batches(PRED_BATCH, PRED_REF_BATCHES)])

    card_r, cpu_r = res["cuda"], res["cpu"]
    vals = {dev: values(dev) for dev in setups}
    # by threshold: the modes kept on one device only, and those of them
    # farther than PRED_EDGE from it
    flips, far = {}, {}
    for th in {0.7, *cpu_r["sweep"]}:
        f = (vals["cuda"] >= th) != (vals["cpu"] >= th)
        flips[th] = int(f.sum())
        far[th] = int((f & (np.abs(vals["cpu"] - th) > PRED_EDGE)).sum())
    flat = {}
    for name in ("evaluate", "lengths"):
        for k, v in cpu_r[name].items():
            flat[f"{name}.{k}"] = (0.7 if name == "evaluate" else None,
                                   k, card_r[name][k], v)
    for th, row in cpu_r["sweep"].items():
        for k, v in row.items():
            flat[f"sweep.{th}.{k}"] = (th, k, card_r["sweep"][th][k], v)
    errs = {n: abs(a - b) / max(abs(b), 1e-6)
            for n, (_, _, a, b) in flat.items()}
    excused, bad = [], {}
    for n, (th, k, a, b) in flat.items():
        if th is not None and flips[th] and "filtered" in k:
            excused.append(n)
        elif th is not None and flips[th] and k == "kept_frac":
            excused.append(n)
            if abs(a - b) > 2 * flips[th] / vals["cpu"].size:
                bad[n] = abs(a - b)
        elif errs[n] > PRED_EVAL_REL:
            bad[n] = errs[n]
    value_err = float(np.abs(vals["cuda"] - vals["cpu"]).max())
    emit("predictor_eval", reference_batches=PRED_REF_BATCHES,
         length_batches=PRED_REF_LENGTH_BATCHES,
         card_seconds=card_r["seconds"], cpu_seconds=cpu_r["seconds"],
         worst_rel=max(errs.values()), worst_metric=max(errs, key=errs.get),
         tolerance=PRED_EVAL_REL, value_max_abs_err=value_err,
         modes=int(vals["cpu"].size),
         modes_near_0_7=int((np.abs(vals["cpu"] - 0.7) <= PRED_EDGE).sum()),
         kept_on_one_device_by_threshold=flips, excused=sorted(excused),
         failing=bad)
    if bad or any(far.values()):
        raise SystemExit(f"predictor_eval: the card's metrics disagree with "
                         f"the CPU's: {bad}, modes kept on one device away "
                         f"from the threshold {far}")
    return launches


def predictor_paths(card, vp, scenes):
    """The jrdb preset (246-token local sequences) and the lstm preset at
    full width: 2 train steps and one predict each, finite, timed."""
    import torch
    from emloco_tpu_torch.learning import ValuePoseNet
    from emloco_tpu_torch.physics import linalg
    from emloco_tpu_torch.prediction.presets import configs
    from emloco_tpu_torch.prediction.train import PredictorTrainer
    linalg.reset_launch_counts()
    batches = list(scenes.batches(PRED_BATCH, 3))
    for preset in ("jrdb", "lstm"):
        mcfg, pcfg = configs(preset)
        tr = PredictorTrainer(mcfg, pcfg, vnet=ValuePoseNet(device="cuda"),
                              device="cuda")
        ts = tr.init(0, vnet_params=vp)
        ts, _ = tr.train_step(ts, *batches[0])               # warm-up
        torch.cuda.synchronize()
        t = time.time()
        aux = []
        for b in batches[1:]:
            ts, a = tr.train_step(ts, *b)
            aux.append({k: v.item() for k, v in a.items()})
        dt = time.time() - t
        pred = tr.predict(ts.params, batches[0].obs, batches[0].padding_mask)
        finite = (all(math.isfinite(v) for a in aux for v in a.values())
                  and bool(torch.isfinite(pred).all()))
        shape = tuple(pred.shape)
        want = (PRED_BATCH, mcfg.pred_frames, mcfg.nmode, 2)
        emit("predictor_paths", card=card, preset=preset,
             model=dataclasses.asdict(mcfg), train=dataclasses.asdict(pcfg),
             local_tokens=(mcfg.total_frames + mcfg.obs_frames * (
                 1 + mcfg.use_3dbb + mcfg.num_3dpose
                 + mcfg.num_2dpose * mcfg.use_2dpose)
                 if mcfg.arch == "transmotion" else None),
             steps=len(aux), seconds=dt, steps_per_s=len(aux) / dt,
             losses=aux, predict_shape=shape, finite=finite)
        if not (finite and shape == want):
            raise SystemExit(f"predictor_paths {preset}: finite {finite}, "
                             f"predict shape {shape} (expected {want})")
    launches = dict(linalg.LAUNCHES)
    zero_launches("predictor_paths", launches)
    return launches


def sync(dev):
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def eq_trainer(arch, device, vnet=True):
    """The compact EqMotion (EqMotionConfig(): past 8, future 12, hidden
    64, 32 channels, 4 layers, 20 modes) or the architecture-exact one
    (eth_full_config(): nf 64, 64 channels, 4 layers, 20 modes) on
    `device`; with `vnet`, the EmLoco loss at EQ_VALUE_W through
    ValuePoseNet(use_pose=False, use_vel=True)."""
    from emloco_tpu_torch.learning import ValuePoseNet
    from emloco_tpu_torch.prediction import eqmotion as E
    from emloco_tpu_torch.prediction.eqmotion_full import (EqMotionFullEth,
                                                           eth_full_config)
    model = (EqMotionFullEth(eth_full_config(), device=device)
             if arch == "full" else None)
    return E.EqMotionTrainer(
        E.EqMotionConfig(),
        vnet=ValuePoseNet(use_pose=False, use_vel=True, device=device)
        if vnet else None, valueloss_w=EQ_VALUE_W if vnet else 0.0,
        model=model, device=device)


def eq_vnet():
    """The frozen LocoVal state_dict (velocity only) from EQ_VNET_SEED, on
    the CPU."""
    import torch
    from emloco_tpu_torch.learning import ValuePoseNet
    vnet = ValuePoseNet(use_pose=False, use_vel=True,
                        generator=torch.Generator().manual_seed(EQ_VNET_SEED),
                        device="cpu")
    return {k: v.detach().clone() for k, v in vnet.named_parameters()}


EQ_HEADS = {"compact": "head.", "full": "core.predict_head."}


def eqmotion_train(card, vp, dev="cuda"):
    """A warm-up step, then one epoch of the CLI's defaults (EQ_STEPS steps
    of EQ_BATCH synthetic ETH scenes of EQ_AGENTS agents) of each
    architecture with the EmLoco loss: losses finite, parameters moved, the
    LocoVal parameters bit-equal, the value loss nonzero and its gradient
    at the heads nonzero (the step's head gradient less the WTA loss's
    alone), none of the engine's kernels launched. Returns {arch: (trainer,
    state after the warm-up, a batch)} and the launch counts."""
    import torch
    from emloco_tpu_torch.physics import linalg
    from emloco_tpu_torch.prediction import eqmotion as E
    states = {}
    linalg.reset_launch_counts()
    for arch in ("compact", "full"):
        tr = eq_trainer(arch, dev)
        ts, vpc = tr.init(0, vnet_params=vp)
        vp0 = {k: v.clone() for k, v in vpc.items()}
        gen = torch.Generator(device=dev).manual_seed(EQ_DATA_SEED)
        batches = [E.synthetic_eth_batch(gen, EQ_BATCH, EQ_AGENTS)
                   for _ in range(EQ_STEPS + 2)]
        t = time.time()
        ts, _ = tr.train_step(ts, vpc, *batches[0])          # warm-up
        sync(dev)
        warm_s = time.time() - t
        start = ts
        t = time.time()
        aux = []
        for b in batches[1:EQ_STEPS + 1]:
            ts, a = tr.train_step(ts, vpc, *b)
            aux.append(a)
        sync(dev)
        dt = time.time() - t
        aux = [{k: v.item() for k, v in a.items()} for a in aux]
        moved = any(not torch.equal(ts.params[k], start.params[k])
                    for k in ts.params)
        vnet_same = all(torch.equal(vpc[k], vp0[k]) for k in vp0)
        _, _, g = tr.loss_and_grads(ts.params, vpc, *batches[-1])
        _, _, g_wta = eq_trainer(arch, dev, vnet=False).loss_and_grads(
            ts.params, None, *batches[-1])
        head = max((g[k] - g_wta[k]).abs().max().item() for k in g
                   if k.startswith(EQ_HEADS[arch]))
        finite = all(math.isfinite(v) for a in aux for v in a.values())
        value_nonzero = all(a["value_loss"] > 0 for a in aux)
        emit("eqmotion_train", card=card, arch=arch,
             model=dataclasses.asdict(tr.model.cfg),
             params=sum(v.numel() for v in ts.params.values()),
             batch=EQ_BATCH, agents=EQ_AGENTS, value_w=EQ_VALUE_W,
             warmup_seconds=warm_s, steps=EQ_STEPS, seconds=dt,
             steps_per_s=EQ_STEPS / dt, ms_per_step=dt / EQ_STEPS * 1e3,
             first=aux[0], last=aux[-1], finite=finite, moved=moved,
             vnet_bit_equal=vnet_same, value_grad_at_heads=head)
        if not (finite and moved and vnet_same and value_nonzero
                and head > 0):
            raise SystemExit(f"eqmotion_train {arch}: finite {finite}, "
                             f"moved {moved}, valuenet kept {vnet_same}, "
                             f"value loss nonzero {value_nonzero}, value "
                             f"gradient at the heads {head}")
        states[arch] = (tr, start, batches[-1])
    launches = dict(linalg.LAUNCHES)
    zero_launches("eqmotion_train", launches)
    return states, launches


def eq_step(arch, runs_on, ts, batch, vp, dtype, record=False):
    """One train step of `arch` in `dtype` on each device of `runs_on` from
    the same state and batch: its loss terms, gradients, updated parameters
    and eval-mode prediction on the CPU, the WTA winners, and with
    `record` each layer's reflection-gate `product` (q·k over the
    coordinates, from the layer_q and layer_k outputs)."""
    import torch
    runs = {}
    for dev in runs_on:
        tr = eq_trainer(arch, dev)

        def to(x):
            return cast(x, dev, dtype)
        p = {k: to(v) for k, v in ts.params.items()}
        v = {k: to(x) for k, x in vp.items()}
        b = [to(x) for x in batch]
        qk = {}
        hooks = [m.register_forward_hook(
                     lambda m, i, o, n=n, qk=qk:
                     qk.__setitem__(n, o.detach()))
                 for n, m in tr.model.named_modules()
                 if record and n.endswith(("layer_q", "layer_k"))]
        t = time.time()
        try:
            _, aux, grads = tr.loss_and_grads(p, v, *b)
            p1, _ = tr.tx.update(grads, tr.tx.init(p), p)
        finally:
            for h in hooks:
                h.remove()
        pred = tr.predict(p, b[0])
        sync(dev)
        seconds = time.time() - t
        d = pred[:, 0] - b[1][:, 0:1]
        win = torch.sqrt((d * d).sum(-1) + 1e-12).mean(-1).argmin(-1)
        product = {n[:-len(".layer_q")]: (qk[n] * qk[n[:-1] + "k"]).sum(2)
                   .cpu() for n in qk if n.endswith("layer_q")}
        runs[dev] = dict(seconds=seconds,
                         terms={k: x.item() for k, x in aux.items()},
                         grads={k: x.cpu() for k, x in grads.items()},
                         params={k: x.cpu() for k, x in p1.items()},
                         pred=pred.cpu(), win=win.cpu(), product=product)
    return runs


def eqmotion_reference(states, vp, card_dev="cuda"):
    """One train step of each architecture on the card and on the CPU from
    the same state and batch: in float64 with train_reference's gates (loss
    terms 1e-4, gradients 1e-4 of each leaf's largest |g|, updates 1e-3 ×
    lr where the gradient stands clear); in float32, the main path's step,
    with its loss terms held at 1e-4 and its gradients and updates printed
    beside the rows whose WTA winner differs between the devices and, for
    the full model, the reflection-gate products whose sign differs (the
    gate's kink, where float32 gradients may part); eval-mode predict in
    float32 within 1e-4 of the largest |output|."""
    import torch
    lr = 5e-4
    for arch, (tr, ts, batch) in states.items():
        r64 = eq_step(arch, (card_dev, "cpu"), ts, batch, vp, torch.float64)
        card, cpu = r64[card_dev], r64["cpu"]
        loss_err = {k: abs(card["terms"][k] - v) / max(abs(v), 1e-30)
                    for k, v in cpu["terms"].items()}
        grad_err, upd_err = {}, {}
        for k, g in cpu["grads"].items():
            tol = GRAD_REL * max(g.abs().max().item(), 1e-30)
            grad_err[k] = (card["grads"][k] - g).abs().max().item() / (
                tol / GRAD_REL)
            clear = g.abs() >= tol
            du = (card["params"][k] - cpu["params"][k])[clear]
            upd_err[k] = du.abs().max().item() / lr if du.numel() else 0.0
        ok64 = (max(loss_err.values()) <= LOSS_REL
                and max(grad_err.values()) <= GRAD_REL
                and max(upd_err.values()) <= UPDATE_LR)
        r32 = eq_step(arch, (card_dev, "cpu"), ts, batch, vp, torch.float32,
                      record=arch == "full")
        c32, p32 = r32[card_dev], r32["cpu"]
        loss32 = {k: abs(c32["terms"][k] - v) / max(abs(v), 1e-30)
                  for k, v in p32["terms"].items()}
        grad32 = {k: (c32["grads"][k] - g).abs().max().item()
                  / max(g.abs().max().item(), 1e-30)
                  for k, g in p32["grads"].items()}
        upd32 = max((c32["params"][k] - v).abs().max().item() / lr
                    for k, v in p32["params"].items())
        pred_err = ((c32["pred"] - p32["pred"]).abs().max().item()
                    / p32["pred"].abs().max().item())
        win_flips = int((c32["win"] != p32["win"]).sum())
        gate_flips = {n: int(((c32["product"][n] >= 0)
                              != (p32["product"][n] >= 0)).sum())
                      for n in p32["product"]}
        emit("eqmotion_reference", arch=arch, batch=EQ_BATCH,
             float64=dict(loss_max_rel=max(loss_err.values()),
                          grad_max_rel=max(grad_err.values()),
                          update_max_lr=max(upd_err.values()),
                          card_seconds=card["seconds"],
                          cpu_seconds=cpu["seconds"]),
             float32=dict(terms_card=c32["terms"], terms_cpu=p32["terms"],
                          loss_max_rel=max(loss32.values()),
                          grad_max_rel=max(grad32.values()),
                          grad_worst_leaf=max(grad32, key=grad32.get),
                          update_max_lr=upd32, predict_max_rel=pred_err,
                          card_seconds=c32["seconds"],
                          cpu_seconds=p32["seconds"]),
             wta_winner_flips=win_flips, wta_rows=int(p32["win"].numel()),
             gate_sign_flips=gate_flips,
             gate_products=sum(v.numel() for v in p32["product"].values()),
             tolerances=dict(loss=LOSS_REL, grad=GRAD_REL, update_lr=UPDATE_LR,
                             loss32=EQ_LOSS32_REL, predict=PRED_PREDICT_REL))
        if not (ok64 and max(loss32.values()) <= EQ_LOSS32_REL
                and pred_err <= PRED_PREDICT_REL):
            raise SystemExit(
                f"eqmotion_reference {arch}: float64 loss "
                f"{max(loss_err.values()):.3g}, gradients "
                f"{max(grad_err.values()):.3g}, updates "
                f"{max(upd_err.values()):.3g} lr; float32 loss "
                f"{max(loss32.values()):.3g}, predict {pred_err:.3g}")


def eqmotion_eval(card, states, vp, dev="cuda"):
    """`evaluate` with the LocoVal filter at 0.7 on the ETH fixture's
    windows (4 agents) with the compact model after its epoch, on the card
    and on the CPU: every metric within 1e-4 of its magnitude, a mode kept
    on one device only only within 1e-5 of the threshold (counted; then the
    filtered minimum is excused); then `train_eqmotion --ethucy <fixture>
    --epochs 2 --valuenet <file>` on the card, its eqmotion.ckpt read back
    bit-equal. Returns the launch counts."""
    import tempfile

    import torch
    from emloco_tpu_torch import train_eqmotion
    from emloco_tpu_torch.physics import linalg
    from emloco_tpu_torch.prediction import eqmotion as E
    from emloco_tpu_torch.prediction import metrics as M
    from emloco_tpu_torch.utils import checkpoint as ckpt
    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "data", "ethucy_fixture.txt")
    linalg.reset_launch_counts()
    past, future = E.ethucy_windows(fixture, num_agents=EQ_AGENTS)
    tr, ts, _ = states["compact"]
    res, vals = {}, {}
    for d in (dev, "cpu"):
        t_ = eq_trainer("compact", d)
        p = {k: v.to(d) for k, v in ts.params.items()}
        v = {k: x.to(d) for k, x in vp.items()}
        t = time.time()
        res[d] = t_.evaluate(p, past, future, vnet_params=v, threshold=0.7)
        sync(d)
        res[d]["seconds"] = time.time() - t
        pred = t_.predict(p, torch.as_tensor(past, device=d))[:, 0]
        vals[d] = t_.mode_values(v, past, pred).cpu()
    keep = {d: M.locoval_filter(None, vals[d], 0.7) for d in vals}
    flips = keep[dev] != keep["cpu"]
    far = int((flips & ((vals["cpu"] - 0.7).abs() > PRED_EDGE)).sum())
    errs = {k: abs(res[dev][k] - v) / max(abs(v), 1e-6)
            for k, v in res["cpu"].items() if k != "seconds"}
    excused = ["ade_filtered_min"] if int(flips.sum()) else []
    bad = {k: e for k, e in errs.items()
           if e > PRED_EVAL_REL and k not in excused}
    with tempfile.TemporaryDirectory() as out:
        vpath = os.path.join(out, "valuenet.ckpt")
        ckpt.save_valuenet(vpath, vp, dict(use_pose=False, use_vel=True))
        buf = io.StringIO()
        t = time.time()
        with contextlib.redirect_stdout(buf):
            cli_tr, cli_ts, cli_ev = train_eqmotion.main([
                "--ethucy", fixture, "--epochs", "2", "--valuenet", vpath,
                "--out", out, "--device", dev])
        cli_s = time.time() - t
        lines = [json.loads(ln) for ln in buf.getvalue().splitlines()]
        tree, meta = ckpt.load_pytree(os.path.join(out, "eqmotion.ckpt"))
        back = cli_tr.params_from(tree["params"])
        same = all(torch.equal(back[k], cli_ts.params[k])
                   for k in cli_ts.params) and sorted(back) == sorted(
                       cli_ts.params)
    finite = all(math.isfinite(v) for ln in lines for v in ln.values()
                 if isinstance(v, float)) and all(
        math.isfinite(v) for v in cli_ev.values())
    launches = dict(linalg.LAUNCHES)
    emit("eqmotion_eval", card=card, windows=int(past.shape[0]),
         agents=EQ_AGENTS, threshold=0.7, evaluate_card=res[dev],
         evaluate_cpu=res["cpu"], worst_rel=max(errs.values()),
         tolerance=PRED_EVAL_REL, modes=int(vals["cpu"].numel()),
         kept_on_one_device=int(flips.sum()), kept_away_from_threshold=far,
         excused=excused, failing=bad, train_eqmotion=lines,
         train_eqmotion_seconds=cli_s, checkpoint_bit_equal=same,
         checkpoint_metadata=meta, launches=launches)
    zero_launches("eqmotion_eval", launches)
    if bad or far or not (same and finite):
        raise SystemExit(f"eqmotion_eval: metrics {bad}, modes kept on one "
                         f"device away from the threshold {far}, checkpoint "
                         f"bit-equal {same}, finite {finite}")
    return launches


def eval_policy_phase(card):
    """`eval_policy --grid --games 1` at the bench's training configuration
    (1,600 envs): four conditions, each with a finite mse or no latched
    episode, and the factor 32 and resolve 64 times in each condition's
    rollouts, read by the launch counters around them; then
    `rollout_with_rewards` for GIF_STEPS steps of env 0 of the last
    condition's policy: frames finite, factor GIF_STEPS and resolve 2 ×
    GIF_STEPS launches. Returns the launch counts of both."""
    import numpy as np
    import torch
    from emloco_tpu_torch import eval_policy
    from emloco_tpu_torch.learning import players
    from emloco_tpu_torch.learning.value_train import LocoValTrainer
    from emloco_tpu_torch.physics import linalg
    collect = LocoValTrainer.collect_predictions
    per, last = [], {}

    def counted(self, vts, num_epochs=4):
        linalg.reset_launch_counts()
        out = collect(self, vts, num_epochs)
        sync(vts.cum_reward.device)
        per.append(dict(linalg.LAUNCHES))
        last.update(trainer=self, vts=out[0])
        return out

    buf = io.StringIO()
    t = time.time()
    LocoValTrainer.collect_predictions = counted
    try:
        with contextlib.redirect_stdout(buf):
            lines = eval_policy.main(["--grid", "--games", "1",
                                      "--num-envs", str(TRAIN_ENVS)])
    finally:
        LocoValTrainer.collect_predictions = collect
    total_s = time.time() - t
    want = dict.fromkeys(per[0], 0)
    want.update({"cholesky_factor_blocked_t": 32,
                 "cholesky_resolve_blocked_t": 64})
    grid_ok = (len(lines) == 4 and len(per) == 4
               and all(c == want for c in per)
               and all((ln["mse"] is not None and math.isfinite(ln["mse"]))
                       or ln["latched"] == 0 for ln in lines))
    for ln, c in zip(lines, per):
        emit("eval_policy", card=card, **ln, launches=c)
    grid = {k: sum(c[k] for c in per) for k in per[0]}
    tr, vts = last["trainer"], last["vts"]
    linalg.reset_launch_counts()
    t = time.time()
    frames, rewards, traj = players.rollout_with_rewards(tr.agent, vts.policy,
                                                         GIF_STEPS)
    dt = time.time() - t
    roll = dict(linalg.LAUNCHES)
    want_roll = dict.fromkeys(roll, 0)
    want_roll.update({"cholesky_factor_blocked_t": GIF_STEPS,
                      "cholesky_resolve_blocked_t": 2 * GIF_STEPS})
    finite = bool(np.isfinite(frames).all()
                  and all(np.isfinite(v).all() for v in rewards.values()))
    emit("eval_policy", card=card, grid_seconds=total_s,
         rollout_with_rewards=dict(
             steps=GIF_STEPS, num_envs=TRAIN_ENVS, seconds=dt,
             steps_per_s=GIF_STEPS / dt, frames_shape=list(frames.shape),
             finite=finite, mean_total=float(rewards["total"].mean()),
             traj_verts=int(traj.shape[0]), launches=roll))
    if not (grid_ok and finite and roll == want_roll):
        raise SystemExit(f"eval_policy: lines {lines}, launches {per} "
                         f"(expected {want} each), rollout finite {finite}, "
                         f"launches {roll} (expected {want_roll})")
    return grid, roll


def prediction_tools(card, vp_pose, dev="cuda"):
    """collect_vis_data on the JTA fixture at the jta preset's full width,
    card against CPU within 1e-4 of each array's largest magnitude;
    export_scene_dataset of 32 synthetic scenes read back equal;
    `tune_predictor --trials 2 --epochs 1 --batches 2` at the jta preset,
    both trials finite, then the same command resumes after them. Returns
    the launch counts."""
    import tempfile

    import numpy as np
    from emloco_tpu_torch import tune_predictor
    from emloco_tpu_torch.learning import ValuePoseNet
    from emloco_tpu_torch.physics import linalg
    from emloco_tpu_torch.prediction import export
    from emloco_tpu_torch.prediction import visualize as V
    from emloco_tpu_torch.prediction.data import NdjsonScenes, SyntheticScenes
    from emloco_tpu_torch.prediction.presets import configs
    from emloco_tpu_torch.prediction.train import PredictorTrainer
    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "data", "jta_all_cues_fixture.ndjson")
    linalg.reset_launch_counts()
    mcfg, pcfg = configs("jta")
    params = PredictorTrainer(mcfg, pcfg, device="cpu").init(0).params
    vis, secs = {}, {}
    for d in (dev, "cpu"):
        tr = PredictorTrainer(mcfg, pcfg, device=d)
        t = time.time()
        vis[d] = V.collect_vis_data(
            tr, {k: v.to(d) for k, v in params.items()},
            NdjsonScenes(fixture, seed=PRED_EVAL_SEED), PRED_BATCH,
            PRED_REF_BATCHES, vnet=ValuePoseNet(device=d),
            vnet_params={k: v.to(d) for k, v in vp_pose.items()},
            pose_z_flip=pcfg.pose_z_flip)
        secs[d] = time.time() - t
    errs = {k: float(np.abs(vis[dev][k] - v).max()
                     / max(np.abs(v).max(), 1e-30))
            for k, v in vis["cpu"].items()}
    with tempfile.TemporaryDirectory() as out:
        t = time.time()
        bank = export.export_scene_dataset(
            SyntheticScenes(num_people=4, seed=0),
            os.path.join(out, "bank.pkl"), num_scenes=EXPORT_SCENES)
        trajs, poses, vels = export.load_traj_bank(os.path.join(out,
                                                                "bank.pkl"))
        export_s = time.time() - t
        bank_ok = (np.array_equal(trajs, bank) and np.isfinite(bank).all()
                   and poses.shape == (len(bank), 24, 3))
        tune = ["--trials", "2", "--epochs", "1", "--batches", "2",
                "--out", out]
        buf = io.StringIO()
        t = time.time()
        with contextlib.redirect_stdout(buf):
            summary, trials = tune_predictor.main(tune)
            again, resumed = tune_predictor.main(tune)
        tune_s = time.time() - t
    launches = dict(linalg.LAUNCHES)
    tune_ok = (len(trials) == 2 and not resumed
               and all(math.isfinite(t.get("val_ade", math.nan))
                       for t in trials) and again["num_trials"] == 2)
    emit("prediction_tools", card=card, preset="jta",
         collect_vis_data=dict(batch=PRED_BATCH, batches=PRED_REF_BATCHES,
                               max_rel=errs, tolerance=PRED_EVAL_REL,
                               card_seconds=secs[dev],
                               cpu_seconds=secs["cpu"],
                               pred_shape=list(vis["cpu"]["pred"].shape)),
         export=dict(scenes=int(len(bank)), shape=list(bank.shape),
                     seconds=export_s, reloaded_equal=bool(bank_ok)),
         tune_predictor=dict(trials=trials, summary=summary,
                             resumed_trials=len(resumed), seconds=tune_s),
         launches=launches)
    zero_launches("prediction_tools", launches)
    if not (max(errs.values()) <= PRED_EVAL_REL and bank_ok and tune_ok):
        raise SystemExit(f"prediction_tools: collect_vis_data {errs}, bank "
                         f"{bank_ok}, tune {trials} / resumed {resumed}")
    return launches


# ---------------------------------------------------------------------------
# 39-44: the system's entry point, cli/run.py, over the YAML configs
# ---------------------------------------------------------------------------

_HERE = os.path.dirname(os.path.abspath(__file__))
PACER = os.path.join(_HERE, "configs", "pacer_terrain.yaml")
JTA_CONFIG = os.path.join(_HERE, "configs", "jta_predictor.yaml")
VIEWER_CHUNKS, VIEWER_STEPS = 5, 4
# train-policy --profile at a reduced width: the trace holds every kernel
# and runtime call of an epoch, so the rollout is cut to 4 control steps
PROFILE_ARGS = ("env.num_envs=256", "amp.horizon=4", "amp.num_minibatches=2",
                "amp.mini_epochs=1", "amp.amp_batch_size=256",
                "amp.amp_replay_size=4096")


def run_cli(argv):
    """cli.run.main(argv) on the card, the one helper of phases 39-44:
    (its return value, the kernels' launch counts around it, its seconds to
    a synchronize, its stdout)."""
    import torch
    from emloco_tpu_torch.cli import run
    from emloco_tpu_torch.physics import linalg
    buf = io.StringIO()
    torch.cuda.synchronize()
    linalg.reset_launch_counts()
    t = time.time()
    with contextlib.redirect_stdout(buf):
        out = run.main(list(argv))
    torch.cuda.synchronize()
    return out, dict(linalg.LAUNCHES), time.time() - t, buf.getvalue()


def arrow_launches(phase, launches, factor, resolve):
    """Fails unless the factor and the resolve launched `factor` and
    `resolve` times and no other kernel launched."""
    want = dict.fromkeys(launches, 0)
    want.update({"cholesky_factor_blocked_t": factor,
                 "cholesky_resolve_blocked_t": resolve})
    if launches != want:
        raise SystemExit(f"{phase}: launch counts {launches}, expected "
                         f"{want}")


def tree_equal(a, b) -> bool:
    """Tensors, dicts and TensorStructs equal bit for bit, leaf by leaf."""
    import torch
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape and torch.equal(a, b.to(a.device)))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(tree_equal(a[k], b[k])
                                            for k in a)
    if dataclasses.is_dataclass(a):
        return all(tree_equal(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))
    return a == b


def jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def cli_world(card):
    """configs/pacer_terrain.yaml's world built by `_build_world` on the
    card and on the CPU: terrain, spawn table, trajectory bank and motion
    library bit-equal; then the first control step at 8 envs on it, card
    against CPU, under phase 5's gates. Returns the terrain's heights."""
    import numpy as np
    import torch
    from emloco_tpu_torch.cli import run
    from emloco_tpu_torch.utils.config import load_config
    cfg = load_config(PACER)
    secs = {}
    envs = {}
    for d in ("cuda", "cpu"):
        t = time.time()
        envs[d] = run._build_world(cfg, d)
        sync(d)
        secs[d] = time.time() - t
    g, c = envs["cuda"], envs["cpu"]
    pairs = {k: (getattr(g.terrain, k), getattr(c.terrain, k))
             for k in ("heights", "corner_tex", "spawnable_xy")}
    pairs["real_traj_bank"] = (g.real_traj_bank, c.real_traj_bank)
    for f in dataclasses.fields(g.motion_lib):
        pairs[f"motion_lib.{f.name}"] = (getattr(g.motion_lib, f.name),
                                         getattr(c.motion_lib, f.name))
    equal = {k: bool(a.device.type == "cuda" and tree_equal(b, a.cpu()))
             for k, (a, b) in pairs.items()}
    emit("cli_world", card=card, config=os.path.relpath(PACER, _HERE),
         task=cfg.task, num_envs=cfg.env.num_envs, terrain=cfg.terrain,
         heights_shape=list(g.terrain.heights.shape),
         spawn_points=int(g.terrain.spawnable_xy.shape[0]),
         bank_shape=list(g.real_traj_bank.shape),
         motions=int(g.motion_lib.num_motions),
         card_seconds=secs["cuda"], cpu_seconds=secs["cpu"],
         bit_equal=equal)
    if not all(equal.values()):
        raise SystemExit(f"cli_world: card and CPU worlds differ: {equal}")
    card_vs_cpu("cli_world", cfg.env, g,
                torch.Generator(device="cuda").manual_seed(4),
                config=os.path.relpath(PACER, _HERE))
    heights = np.asarray(c.terrain.heights.numpy())
    del envs, g, c
    return heights, cfg.terrain.get("cell", 0.1)


def cli_train_policy(card, out):
    """`train-policy --config configs/pacer_terrain.yaml epochs=2
    save_every=1` at 1,600 envs: factor 64 and resolve 128 launches; the
    checkpoint read back bit-equal to the final state; the jsonl row and
    the tb/ event file (read with read_scalars) equal; then `--resume` one
    epoch: factor 32 and resolve 64, policy_00000002.ckpt with the metadata
    epoch 2 (absolute), its state read back bit-equal. Each epoch's seconds
    (synchronized) and env-steps/s. Returns (policy file, launches)."""
    import numpy as np
    import torch
    from emloco_tpu_torch.learning.amp_agent import AMPAgent
    from emloco_tpu_torch.utils.checkpoint import load_pytree, restore_policy
    from emloco_tpu_torch.utils.tracking import read_scalars
    inner = AMPAgent.train_epoch
    seconds = []

    def timed(self, ts):
        torch.cuda.synchronize()
        t = time.time()
        res = inner(self, ts)
        torch.cuda.synchronize()
        seconds.append(time.time() - t)
        return res

    def reloaded(path, ts):
        tree, meta = load_pytree(path)
        back = restore_policy(ts, tree)
        same = all(tree_equal(getattr(ts, k), getattr(back, k)) for k in (
            "params", "obs_norm", "amp_norm", "value_norm", "opt_state"))
        return same, meta

    base = ["train-policy", "--config", PACER, f"out_dir={out}"]
    AMPAgent.train_epoch = timed
    try:
        ts, launches, secs, _ = run_cli([*base, "epochs=2", "save_every=1"])
        ck1 = os.path.join(out, "policy_00000001.ckpt")
        same1, meta1 = reloaded(ck1, ts)
        rows = jsonl(os.path.join(out, "policy.metrics.jsonl"))
        (ev,) = os.listdir(os.path.join(out, "tb"))
        scalars = list(read_scalars(os.path.join(out, "tb", ev)))
        tb_equal = (len(rows) == 1 and {s for s, _, _ in scalars} == {0}
                    and len(scalars) == sum(isinstance(v, float)
                                            for v in rows[0].values())
                    and all(v == float(np.float32(rows[0][k]))
                            for _, k, v in scalars))
        ts2, launches2, secs2, _ = run_cli([*base, "--resume", ck1,
                                            "epochs=1"])
        same2, meta2 = reloaded(os.path.join(out, "policy_00000002.ckpt"),
                                ts2)
    finally:
        AMPAgent.train_epoch = inner
    steps = 32 * 1600
    finite = all(math.isfinite(v) for v in rows[0].values()
                 if isinstance(v, float))
    emit("cli_train_policy", card=card, epochs=2, resumed_epochs=1,
         num_envs=1600, epoch_seconds=seconds,
         env_steps_per_s=[steps / s for s in seconds], seconds=secs,
         resume_seconds=secs2, launches=launches, resume_launches=launches2,
         files=sorted(os.listdir(out)), checkpoint_bit_equal=[same1, same2],
         checkpoint_epochs=[meta1.get("epoch"), meta2.get("epoch")],
         resumed_state_epoch=ts2.epoch, metrics_row=rows[0],
         tb_scalars=len(scalars), tb_equals_jsonl=tb_equal, finite=finite)
    arrow_launches("cli_train_policy", launches, 64, 128)
    arrow_launches("cli_train_policy resume", launches2, 32, 64)
    if not (same1 and same2 and tb_equal and finite
            and meta1.get("epoch") == 1 and meta2.get("epoch") == 2
            and ts2.epoch == 3 and len(seconds) == 3):
        raise SystemExit("cli_train_policy: checkpoints, logs or resume "
                         "wrong (see the phase line)")
    total = {k: launches[k] + launches2[k] for k in launches}
    return ck1, total


def cli_commands(card, out, policy):
    """The other commands once each on the card, at small epochs and
    batches, each returning normally and writing what the JAX command
    writes: train-valuenet --policy (factor 32, resolve 64), eval-policy
    --policy --valuenet --games 1 (32, 64), train-predictor --config
    configs/jta_predictor.yaml --valuenet, eval-predictor
    --sweep-thresholds, optimize-traj, train-eqmotion, tune-predictor
    --trials 2 (none of the engine's kernels), and visualize-pred on a
    vis_dict of the trained predictor (without matplotlib it must raise
    ModuleNotFoundError for it). Returns the launch counts."""
    import importlib.util
    import torch
    from emloco_tpu_torch.prediction import visualize as V
    from emloco_tpu_torch.prediction.data import SyntheticScenes
    from emloco_tpu_torch.prediction.train import PredictorTrainer
    from emloco_tpu_torch.utils.config import load_config
    d = {k: os.path.join(out, k) for k in ("value", "eval", "pred", "opt",
                                           "eq", "tune", "vis")}
    v0 = os.path.join(d["value"], "valuenet_00000000.ckpt")
    pred = os.path.join(d["pred"], "predictor_best.ckpt")
    runs = {}

    def run(name, argv, factor=0, resolve=0):
        res, launches, secs, stdout = run_cli(argv)
        arrow_launches(f"cli_commands {name}", launches, factor, resolve)
        runs[name] = dict(seconds=secs, launches=launches,
                          lines=[json.loads(x) for x in stdout.splitlines()
                                 if x.startswith("{")][-2:])
        return res, launches

    _, lv = run("train-valuenet", [
        "train-valuenet", "--config", PACER, "--policy", policy, "epochs=1",
        f"out_dir={d['value']}"], 32, 64)
    lines, le = run("eval-policy", [
        "eval-policy", "--config", PACER, "--policy", policy, "--valuenet",
        v0, "--games", "1", f"out_dir={d['eval']}"], 32, 64)
    pred_cmd = ["--config", JTA_CONFIG, "--batches", "2", "--valuenet", v0]
    run("train-predictor", ["train-predictor", *pred_cmd, "epochs=1",
                            f"out_dir={d['pred']}"])
    ev = run("eval-predictor", ["eval-predictor", *pred_cmd, "--predictor",
                                pred, "--sweep-thresholds",
                                f"out_dir={d['pred']}"])[0]
    opt = run("optimize-traj", ["optimize-traj", "--valuenet", v0,
                                "--steps", "20", "--batch-size", "64",
                                f"out_dir={d['opt']}"])[0]
    run("train-eqmotion", ["train-eqmotion", "--batches", "2", "epochs=1",
                           f"out_dir={d['eq']}"])
    (summary, trials) = run("tune-predictor", [
        "tune-predictor", "--config", JTA_CONFIG, "--trials", "2",
        "--batches", "2", "epochs=1", f"out_dir={d['tune']}"])[0]
    # a vis_dict of the trained predictor, as eval-predictor --plots saves
    cfg = load_config(JTA_CONFIG)
    tr = PredictorTrainer(cfg.model, cfg.predict, device="cuda")
    vis = V.collect_vis_data(
        tr, tr.params_from(tr.load_checkpoint(pred)["params"]),
        SyntheticScenes(num_people=4, seed=2), 10, 1)
    os.makedirs(d["vis"], exist_ok=True)
    vis_path = os.path.join(d["vis"], "vis_dict.pkl")
    V.save_vis_dict(vis_path, vis)
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    try:
        # (--vis-dicts takes every word after it)
        run("visualize-pred", ["visualize-pred", f"out_dir={d['vis']}",
                               "--vis-dicts", vis_path])
        visualize = "ran"
    except ModuleNotFoundError as e:
        if has_mpl or "matplotlib" not in str(e):
            raise
        visualize = f"refused: {e}"
    files = {k: sorted(os.listdir(v)) for k, v in d.items()
             if os.path.isdir(v)}
    want = {"value": ["tb", "valuenet.metrics.jsonl",
                      "valuenet_00000000.ckpt"],
            "pred": ["predictor.metrics.jsonl", "predictor_best.ckpt", "tb"],
            "eq": ["eqmotion.ckpt", "eqmotion.metrics.jsonl", "tb"],
            "tune": ["trials.jsonl"]}
    finite = (len(lines) == 1 and (lines[0]["mse"] is None
                                   or math.isfinite(lines[0]["mse"]))
              and all(math.isfinite(v) for v in ev["evaluate"].values())
              and math.isfinite(opt["values"][-1].mean().item())
              and len(trials) == 2
              and all(math.isfinite(t.get("val_ade", math.nan))
                      for t in trials))
    emit("cli_commands", card=card, commands=runs, files=files,
         visualize_pred=visualize, finite=finite)
    if not finite or any(files.get(k) != v for k, v in want.items()):
        raise SystemExit(f"cli_commands: outputs {files} (expected "
                         f"{want}), finite {finite}")
    del tr, vis
    torch.cuda.empty_cache()
    return {k: lv[k] + le[k] for k in lv}


def cli_profile(card, out):
    """`train-policy --profile epochs=1` at a reduced width (PROFILE_ARGS):
    the trace written to <out_dir>/trace holds the factor kernel's CUDA
    launches of the traced epoch (horizon 4: 4 of them). Returns the
    launch counts (3 epochs: the warm-up, the traced one, the loop's)."""
    path = os.path.join(out, "trace", "trace.json")
    _, launches, secs, stdout = run_cli([
        "train-policy", "--config", PACER, "--profile", "epochs=1",
        *PROFILE_ARGS, f"out_dir={out}"])
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    factor = [e for e in kernels if "factor_kernel" in e.get("name", "")]
    resolve = [e for e in kernels if "resolve_kernel" in e.get("name", "")]
    emit("cli_profile", card=card, args=list(PROFILE_ARGS), seconds=secs,
         trace_bytes=os.path.getsize(path), events=len(events),
         kernel_events=len(kernels), factor_kernel_events=len(factor),
         resolve_kernel_events=len(resolve),
         factor_kernel_name=factor[0]["name"] if factor else None,
         launches=launches, printed=stdout.strip().splitlines()[-1:])
    arrow_launches("cli_profile", launches, 12, 24)
    if len(factor) != 4 or len(resolve) != 8:
        raise SystemExit(f"cli_profile: the trace holds {len(factor)} "
                         f"factor and {len(resolve)} resolve launches, "
                         "expected 4 and 8")
    return launches


def viewer(card):
    """A ViewerSession over configs/pacer_terrain.yaml's 1,600 envs: 5
    chunks of 4 control steps (factor 20, resolve 40), the controls, then
    the ViewerServer on port 0: /status and POST /control through urllib,
    the sim loop advancing, /frame.png (the error reply without
    matplotlib), a bad command refused; the phase fails unless last_error
    stays None. Returns the launch counts of the 5 chunks."""
    import importlib.util
    import urllib.error
    import urllib.request
    import torch
    from emloco_tpu_torch.cli import run
    from emloco_tpu_torch.envs.viewer_server import (ViewerServer,
                                                      ViewerSession)
    from emloco_tpu_torch.physics import linalg
    from emloco_tpu_torch.utils.config import load_config
    agent, ts = run._agent(load_config(PACER), torch.device("cuda"))
    sess = ViewerSession(agent, ts, chunk_steps=VIEWER_STEPS)
    torch.cuda.synchronize()
    linalg.reset_launch_counts()
    t = time.time()
    for _ in range(VIEWER_CHUNKS):
        sess.step_chunk()
    torch.cuda.synchronize()
    chunk_s = (time.time() - t) / VIEWER_CHUNKS
    launches = dict(linalg.LAUNCHES)
    controls = {"pause": sess.control("pause")["paused"]
                and not sess.step_chunk()}
    u0 = sess.state.physics.u.clone()
    sess.control("push", velocity=[-2.0, 1.0])
    controls["push"] = bool(torch.allclose(
        (sess.state.physics.u - u0)[0, :2].cpu(), torch.tensor([-2.0, 1.0])))
    controls["envs"] = [sess.control(c)["env"]
                        for c in ("prev_env", "next_env")] == [1599, 0]
    controls["follow"] = sess.control("follow")["follow"] is False
    controls["reset"] = sess.control("reset")["step"] == 0

    def call(path, payload=None):
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}{path}",
            data=None if payload is None else json.dumps(payload).encode(),
            method="GET" if payload is None else "POST")
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    server = ViewerServer(sess, port=0, fps=20.0).start()
    try:
        status0 = json.loads(call("/status")[1])
        resumed = json.loads(call("/control", {"cmd": "resume"})[1])
        time.sleep(2.0)
        paused = json.loads(call("/control", {"cmd": "pause"})[1])
        frame_code, frame = call("/frame.png")
        bad_code, _ = call("/control", {"cmd": "bogus"})
        page_code, page = call("/")
    finally:
        server.close()
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    frame_ok = (frame[:8] == b"\x89PNG\r\n\x1a\n" if has_mpl else
                frame_code == 500 and b"matplotlib" in frame)
    http_ok = (status0["num_envs"] == 1600 and status0["paused"]
               and not resumed["paused"] and paused["step"] > 0
               and bad_code == 400 and page_code == 200
               and b"live viewer" in page)
    emit("viewer", card=card, num_envs=1600, chunks=VIEWER_CHUNKS,
         chunk_steps=VIEWER_STEPS, chunk_seconds=chunk_s,
         env_steps_per_s=1600 * VIEWER_STEPS / chunk_s, launches=launches,
         controls=controls, status=paused, frame_code=frame_code,
         frame=frame[:120].decode("latin-1"), http_ok=http_ok,
         last_error=sess.last_error)
    arrow_launches("viewer", launches, VIEWER_CHUNKS * VIEWER_STEPS,
                   2 * VIEWER_CHUNKS * VIEWER_STEPS)
    if not (all(controls.values()) and http_ok and frame_ok
            and sess.last_error is None):
        raise SystemExit(f"viewer: controls {controls}, http {http_ok}, "
                         f"frame {frame_code}, last_error "
                         f"{sess.last_error}")
    del sess, agent, ts
    return launches


def native_helpers(card, heights, cell):
    """The native C++ helpers built with this machine's g++ and held
    against the port's numpy versions: the walkable mask of the pacer
    terrain bit-equal, its spawn table the same cells within 1 float32
    ulp of the larger term, a mesh's rasterization the same cover within
    2e-6 m, and the ndjson reader's scenes of the JTA fixture equal to
    read_ndjson_scenes'. Host times of each."""
    import numpy as np
    from emloco_tpu_torch import native
    from emloco_tpu_torch.physics import mesh_terrain, terrain
    from emloco_tpu_torch.prediction.data import read_ndjson_scenes
    t = time.time()
    native.load_native("terrain_native")
    native.load_native("ndjson_native")
    build_s = time.time() - t
    secs = {}

    def timed(name, fn, *a, **kw):
        t = time.time()
        out = fn(*a, **kw)
        secs[name] = time.time() - t
        return out

    mask = timed("walkable_mask_native", native.fast_walkable_mask,
                 heights, cell)
    mask_p = timed("walkable_mask_numpy", terrain.walkable_mask, heights,
                   cell)
    n = int(mask.sum())
    origin = (-heights.shape[0] * cell / 2, -heights.shape[1] * cell / 2)
    xy = timed("spawn_table_native", native.fast_spawn_table, mask, cell,
               origin, max_pts=n)
    xy_p = timed("spawn_table_numpy", terrain.spawn_table, mask, cell,
                 origin, max_pts=n)
    a, b = xy[np.lexsort(xy.T)], xy_p[np.lexsort(xy_p.T)]
    o = np.asarray(origin, np.float32)
    spawn_ok = (a.shape == b.shape == (n, 2) and bool(
        (np.abs(a - b) <= np.spacing(np.maximum(np.abs(b - o),
                                                np.abs(o)))).all()))
    g = np.stack(np.meshgrid(np.linspace(-3, 3, 31), np.linspace(-3, 3, 31),
                             indexing="ij"), -1).reshape(-1, 2)
    verts = np.concatenate([g, 0.3 * np.sin(g[:, :1] * 1.3)],
                           1).astype(np.float32)
    faces = np.asarray([(i * 31 + j, (i + 1) * 31 + j, i * 31 + j + 1)
                        for i in range(30) for j in range(30)] +
                       [((i + 1) * 31 + j, (i + 1) * 31 + j + 1,
                         i * 31 + j + 1)
                        for i in range(30) for j in range(30)], np.int32)
    grid = (70, 70, 0.1, (-3.5, -3.5))
    h, cover = timed("rasterize_native", native.fast_rasterize_trimesh,
                     verts, faces, *grid)
    h_p, cover_p = timed("rasterize_numpy", mesh_terrain.rasterize_trimesh_np,
                         verts, faces, *grid)
    raster_err = float(np.abs(h[cover] - h_p[cover]).max())
    fixture = os.path.join(_HERE, "tests", "data",
                           "jta_all_cues_fixture.ndjson")
    scenes = timed("ndjson_native", lambda p: native.scenes_to_arrays(
        *native.read_ndjson_fast(p)), fixture)
    ref = timed("ndjson_numpy", read_ndjson_scenes, fixture)
    ndjson_ok = len(scenes) == len(ref) > 0 and all(
        np.array_equal(x, y) for x, y in zip(scenes, ref))
    checks = dict(walkable_mask_bit_equal=bool(np.array_equal(mask, mask_p)),
                  spawn_table_within_ulp=spawn_ok,
                  rasterize_cover_equal=bool(np.array_equal(cover,
                                                            cover_p)),
                  rasterize_within_2um=raster_err <= 2e-6,
                  ndjson_scenes_equal=ndjson_ok)
    emit("native", card=card, build_seconds=build_s, seconds=secs,
         heights_shape=list(heights.shape), walkable=n,
         rasterize_max_abs_err=raster_err, scenes=len(scenes), **checks)
    if not all(checks.values()):
        raise SystemExit(f"native: {checks}")


def cli_phases(card):
    """Phases 39-44 in one temporary output directory; returns the launch
    counts of the runs that step the engine, by path."""
    import tempfile
    heights, cell = cli_world(card)
    with tempfile.TemporaryDirectory() as out:
        policy, by_path = cli_train_policy(card, os.path.join(out, "train"))
        by_path = {"cli_train_policy": by_path}
        by_path["cli_commands"] = cli_commands(card, out, policy)
        by_path["cli_profile"] = cli_profile(card,
                                             os.path.join(out, "profile"))
    by_path["viewer"] = viewer(card)
    native_helpers(card, heights, cell)
    return by_path


# ---------------------------------------------------------------------------
# 45-47: the SMPL body model, retargeting and the importers; data
# parallelism over ranks (parallel/mesh.py, cli.run --mesh)
# ---------------------------------------------------------------------------

# SMPL's published sizes (basicModel: 6,890 vertices, 10 shape components,
# 23 × 9 pose-blendshape features, 24 joints), bodies on the card and the
# CPU's subset; vertices and joints within SMPL_REL of their largest |v|
# (float32 sums of 24 skinning terms and 207 blendshape features in other
# orders on the two devices)
SMPL_V, SMPL_BETAS, SMPL_BODIES, SMPL_CPU_BODIES = 6890, 10, 1600, 64
SMPL_SEED, SMPL_REL = 15, 1e-5
MESH_RANKS = 2
# a run of the entry point over ranks gets this long before it fails; the
# predictor's steps an epoch over the ranks
MESH_TIMEOUT_S = 600
MESH_PRED_STEPS = 8
# a two-joint-chain BVH, 30 frames at 30 fps, in centimetres, y-up
BVH_JOINTS = ("Hips", "LeftUpLeg", "LeftLeg", "LeftFoot", "RightUpLeg",
              "RightLeg", "RightFoot", "Spine", "Neck", "Head")


def smoke_bvh(frames=30):
    """A BVH text of BVH_JOINTS (the hips and both legs in a chain each,
    the spine to the head) with a swinging gait from a fixed formula."""
    import numpy as np
    parents = {"LeftUpLeg": "Hips", "LeftLeg": "LeftUpLeg",
               "LeftFoot": "LeftLeg", "RightUpLeg": "Hips",
               "RightLeg": "RightUpLeg", "RightFoot": "RightLeg",
               "Spine": "Hips", "Neck": "Spine", "Head": "Neck"}
    offs = {"Hips": (0, 0, 0), "LeftUpLeg": (9, -6, 0),
            "LeftLeg": (0, -42, 0), "LeftFoot": (0, -40, 0),
            "RightUpLeg": (-9, -6, 0), "RightLeg": (0, -42, 0),
            "RightFoot": (0, -40, 0), "Spine": (0, 12, 0),
            "Neck": (0, 40, 0), "Head": (0, 10, 0)}
    children = {j: [c for c in BVH_JOINTS if parents.get(c) == j]
                for j in BVH_JOINTS}

    def block(j, depth):
        pad = "  " * depth
        head = "ROOT" if j == "Hips" else "JOINT"
        ch = ("CHANNELS 6 Xposition Yposition Zposition Zrotation "
              "Xrotation Yrotation" if j == "Hips"
              else "CHANNELS 3 Zrotation Xrotation Yrotation")
        out = [f"{pad}{head} {j}", f"{pad}{{",
               f"{pad}  OFFSET {' '.join(str(float(v)) for v in offs[j])}",
               f"{pad}  {ch}"]
        for c in children[j]:
            out += block(c, depth + 1)
        if not children[j]:
            out += [f"{pad}  End Site", f"{pad}  {{",
                    f"{pad}    OFFSET 0.0 -5.0 0.0", f"{pad}  }}"]
        return out + [f"{pad}}}"]

    t = np.arange(frames) / 30.0
    rows = []
    for k in range(frames):
        ph = 2 * np.pi * 1.2 * t[k]
        vals = [100.0 * t[k], 93.0 + 2 * np.cos(2 * ph), 0.0, 0.0, 0.0, 0.0]
        for j in BVH_JOINTS[1:]:
            swing = {"LeftUpLeg": 25 * np.sin(ph),
                     "RightUpLeg": -25 * np.sin(ph),
                     "LeftLeg": 20 * (1 - np.cos(ph)),
                     "RightLeg": 20 * (1 + np.cos(ph))}.get(j, 3 * np.sin(ph))
            vals += [0.0, swing, 0.0]
        rows.append(" ".join(f"{v:.4f}" for v in vals))
    return "\n".join(["HIERARCHY", *block("Hips", 0), "MOTION",
                      f"Frames: {frames}", "Frame Time: 0.0333333", *rows])


def smpl_model(seed=SMPL_SEED):
    """An SMPLModel at SMPL's published sizes with values from `seed`:
    vertices scattered about the rest joints, each skinned to its owner
    joint and three others (weights summing to 1), the regressor each
    joint's owned vertices' mean, small shape and pose blendshapes."""
    import numpy as np
    import torch
    from emloco_tpu_torch.kinematics import body_model as bm
    from emloco_tpu_torch.kinematics.skeleton import forward_kinematics
    from emloco_tpu_torch.kinematics.smpl import SMPLModel
    from emloco_tpu_torch.ops import quat
    rng = np.random.RandomState(seed)
    V, J = SMPL_V, bm.NUM_BODIES
    _, gpos = forward_kinematics(bm.canonical_skeleton(),
                                 quat.identity_like((1, J)),
                                 torch.zeros((1, 3)))
    owner = rng.randint(0, J, V)
    v_template = (gpos[0].numpy()[owner]
                  + rng.randn(V, 3) * 0.05).astype(np.float32)
    w = np.zeros((V, J), np.float32)
    w[np.arange(V), owner] = 1.0
    for _ in range(3):
        w[np.arange(V), rng.randint(0, J, V)] += rng.uniform(0, 0.3, V)
    w /= w.sum(1, keepdims=True)
    jreg = np.zeros((J, V), np.float32)
    for j in range(J):
        idx = np.nonzero(owner == j)[0]
        jreg[j, idx] = 1.0 / len(idx)
    return SMPLModel(
        v_template=v_template,
        shapedirs=(rng.randn(V, 3, SMPL_BETAS) * 0.01).astype(np.float32),
        posedirs=(rng.randn(V, 3, (J - 1) * 9) * 0.001).astype(np.float32),
        j_regressor=jreg, lbs_weights=w, parents=bm.PARENTS)


def kinematics_variants(card):
    """Phase 45: SMPL at full size (card, and the CPU on a subset),
    retargeting, and the importers curated into a motion pickle that
    load_reference_pkl reads on the card."""
    import tempfile

    import numpy as np
    import torch
    from emloco_tpu_torch.kinematics import body_model as bm
    from emloco_tpu_torch.kinematics import bvh, curation
    from emloco_tpu_torch.kinematics import motion_lib as ml
    from emloco_tpu_torch.kinematics.retarget import retarget_motion
    from emloco_tpu_torch.kinematics.skeleton import SkeletonTree
    from emloco_tpu_torch.kinematics.smpl import get_joints_verts
    model = smpl_model()
    rng = np.random.RandomState(SMPL_SEED + 1)
    B = SMPL_BODIES
    pose = torch.as_tensor(rng.uniform(-0.5, 0.5, (B, 72)), dtype=torch.float32)
    betas = torch.as_tensor(rng.randn(B, SMPL_BETAS), dtype=torch.float32)
    trans = torch.as_tensor(rng.randn(B, 3) * 0.5, dtype=torch.float32)
    g = [x.cuda() for x in (pose, betas, trans)]
    get_joints_verts(model, *(x[:8] for x in g))             # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(2):
        t = time.time()
        verts, joints = get_joints_verts(model, *g)
        torch.cuda.synchronize()
        secs.append(time.time() - t)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n = SMPL_CPU_BODIES
    v_c, j_c = get_joints_verts(model, pose[:n], betas[:n], trans[:n])
    verr = rel_err(verts[:n].cpu(), v_c)[1]
    jerr = rel_err(joints[:n].cpu(), j_c)[1]
    finite = bool(torch.isfinite(verts).all() and torch.isfinite(joints).all())
    shapes = [list(verts.shape), list(joints.shape)]
    del verts, joints, g
    torch.cuda.empty_cache()

    # retargeting onto a 14-joint skeleton of the canonical one's names
    src = bm.canonical_skeleton()
    keep = ["Pelvis", "L_Hip", "L_Knee", "L_Ankle", "R_Hip", "R_Knee",
            "R_Ankle", "Torso", "Spine", "Chest", "Neck", "Head",
            "L_Shoulder", "R_Shoulder"]
    idx = [src.index(k) for k in keep]
    par = []
    for j in idx:
        p = int(src.parents[j])
        while p >= 0 and p not in idx:
            p = int(src.parents[p])
        par.append(-1 if p < 0 else idx.index(p))
    tgt = SkeletonTree(names=tuple(keep), parents=np.array(par),
                       local_translation=src.local_translation[idx] * 1.1)
    lib = ml.synthetic_walk_motions(speeds=(1.2,), duration=2.0,
                                    device="cpu")
    ms = ml.get_motion_state(lib, torch.zeros((60,), dtype=torch.long),
                             torch.linspace(0.0, 1.9, 60))
    jmap = {k: k for k in keep if k not in ("L_Knee", "R_Knee", "Chest")}
    R = torch.tensor([0.0, 0.0, 0.38268343, 0.92387953])
    out = {}
    for d in ("cuda", "cpu"):
        out[d] = retarget_motion(src, tgt, jmap, ms["local_rot"].to(d),
                                 ms["root_pos"].to(d),
                                 rotation_to_target=R.to(d), scale=0.9)
    rerr = max(rel_err(a.cpu(), b)[1] for a, b in zip(out["cuda"],
                                                       out["cpu"]))

    # the importers into a motion pickle
    raw = {"poses": (rng.uniform(-0.3, 0.3, (120, 156))).astype(np.float32),
           "trans": (np.cumsum(rng.uniform(0.0, 0.02, (120, 3)), 0)
                     + [0.0, 0.9, 0.0]).astype(np.float32),
           "betas": rng.randn(10).astype(np.float32),
           "mocap_framerate": np.array(60.0)}
    motions = {"bvh_walk": bvh.load_bvh(smoke_bvh()),
               "amass_seq": curation.amass_to_motion(raw)}
    curated = curation.augment_with_flips(
        curation.filter_motions(motions, min_seconds=0.5))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "motions.pkl")
        curation.save_motion_dict(curated, path)
        libs = {d: ml.load_reference_pkl(path, device=d)
                for d in ("cuda", "cpu")}
    lib_err = {f.name: rel_err(getattr(libs["cuda"], f.name).cpu().double(),
                               getattr(libs["cpu"], f.name).double())[1]
               for f in dataclasses.fields(libs["cpu"])
               if getattr(libs["cpu"], f.name).is_floating_point()}
    lib_finite = all(bool(torch.isfinite(getattr(libs["cuda"], k)).all())
                     for k in lib_err)
    emit("kinematics_variants", card=card, smpl=dict(
        bodies=B, vertices=SMPL_V, betas=SMPL_BETAS,
        pose_features=(bm.NUM_BODIES - 1) * 9, shapes=shapes, seconds=secs,
        peak_gb=peak, cpu_bodies=n, verts_rel_err=verr,
        joints_rel_err=jerr, finite=finite, tolerance_rel=SMPL_REL),
         retarget=dict(frames=60, target_joints=len(keep),
                       max_rel_err=rerr), motions=sorted(curated),
         motion_lib=dict(num_motions=int(libs["cuda"].num_motions),
                         frames=int(libs["cuda"].num_frames.sum()),
                         max_rel_err=max(lib_err.values()),
                         finite=lib_finite))
    if not (finite and lib_finite and verr <= SMPL_REL and jerr <= SMPL_REL
            and rerr <= SMPL_REL and max(lib_err.values()) <= SMPL_REL
            and int(libs["cuda"].num_motions) == 4):
        raise SystemExit("kinematics_variants: the card disagrees with the "
                         "CPU (see the phase line)")


def mesh_reference(card):
    """Phase 46: configs/pacer_terrain.yaml's world over MESH_RANKS ranks in
    this process against the one-rank world: the reset rows and one
    control step (STEP_RTOL), then one minibatch's update split over the
    ranks against the one-rank update (train_reference's tolerances)."""
    import torch
    from emloco_tpu_torch.cli import run
    from emloco_tpu_torch.learning.amp_agent import AMPAgent
    from emloco_tpu_torch.parallel import mesh as pmesh
    from emloco_tpu_torch.utils.config import load_config
    cfg = load_config(PACER)
    dev = torch.device("cuda")
    N, R = cfg.env.num_envs, MESH_RANKS
    meshes = [pmesh.Mesh(r, R, dev) for r in range(R)]
    env1 = run._build_world(cfg, dev)
    envs = [run._build_world(cfg, dev, mesh=m) for m in meshes]
    st1 = env1.reset(torch.Generator(device=dev).manual_seed(5))
    sts = [e.reset(torch.Generator(device=dev).manual_seed(5)) for e in envs]
    cat = torch.cat
    reset_err = {k: rel_err(cat([getattr(s.physics, k) for s in sts]),
                            getattr(st1.physics, k))[1]
                 for k in ("root_pos", "body_x", "u")}
    reset_err["traj_verts"] = rel_err(cat([s.traj_verts for s in sts]),
                                      st1.traj_verts)[1]
    act = 0.3 * torch.randn((N, cfg.env.num_actions),
                            generator=torch.Generator(device=dev)
                            .manual_seed(6), device=dev)
    st1, out1 = env1.step(st1, act)
    n = N // R
    steps = [e.step(s, act[r * n:(r + 1) * n])
             for r, (e, s) in enumerate(zip(envs, sts))]
    done = cat([o.done for _, o in steps])
    keep = ~(done | out1.done)
    step_err = {}
    for name, get in (("u", lambda s, o: s.physics.u),
                      ("body_x", lambda s, o: s.physics.body_x),
                      ("reward", lambda s, o: o.reward)):
        step_err[name] = rel_err(cat([get(s, o) for s, o in steps])[keep],
                                 get(st1, out1)[keep])[1]
    # the observation block by block, save the sensor points within EDGE_M
    # of a cell edge (a body a few ulps away reads the other side)
    near = near_edges(env1, st1)[keep]
    obs_err, listed = obs_errors(cfg.env, cat([o.obs for _, o in steps])[
        keep], out1.obs[keep], near)
    step_err.update({f"obs_{k}": v for k, v in obs_err.items()})
    del envs, sts, steps

    # one minibatch of a one-rank epoch, taken by each rank
    agent1 = AMPAgent(env1, cfg.amp)
    ts = agent1.init(cfg.seed)
    ts, batch, last = agent1.rollout(ts)
    ts, pools = agent1.prepare(ts, batch, last)
    before = ts.rng.get_state()
    T, amp = cfg.amp.horizon, cfg.amp

    def first(agent, pools_):
        gen = torch.Generator(device=dev)
        gen.set_state(before)
        return next(agent.minibatches(pools_, gen))

    mb1, demo1, replay1, masks1, _ = first(agent1, pools)
    total1, terms1, g1 = agent1._loss_and_grads(ts.params, mb1, demo1,
                                                 replay1, masks1)
    terms1["total"] = total1
    gsum, tsum, rows = None, None, []
    for m in meshes:
        env_r = run._build_world(cfg, dev, mesh=m)
        agent_r = AMPAgent(env_r, cfg.amp)
        part = {k: v.reshape((T, N) + v.shape[1:])[:, m.block(N)]
                .reshape((T * n,) + v.shape[1:])
                for k, v in pools["data"].items()}
        pools_r = dict(pools, data=part,
                       demo=pools["demo"][:, m.part(amp.amp_batch_size)],
                       replay=pools["replay"][:, m.part(pools["half"])])
        mb, demo, replay, masks, split = first(agent_r, pools_r)
        total, terms, g = agent_r._loss_and_grads(ts.params, mb, demo,
                                                  replay, masks, split)
        terms["total"] = total
        rows.append(int(mb["adv"].shape[0]))
        gsum = g if gsum is None else {k: gsum[k] + g[k] for k in g}
        tsum = (terms if tsum is None
                else {k: tsum[k] + terms[k] for k in terms})
        del env_r, agent_r, pools_r
    lr = amp.lr
    term_err = {k: abs(tsum[k].item() - v.item()) / max(abs(v.item()), 1e-6)
                for k, v in terms1.items()}
    grad_err = {k: ((gsum[k] - g).abs().max()
                    / g.abs().max().clamp(min=1e-12)).item()
                for k, g in g1.items()}
    p1, _, _ = agent1._apply_grads(ts.params, ts.opt_state, g1)
    pr, _, _ = agent1._apply_grads(ts.params, ts.opt_state, gsum)
    update_err = {}
    for k, g in g1.items():
        clear = g.abs() >= GRAD_REL * g.abs().max().clamp(min=1e-12)
        d = (pr[k].double() - p1[k].double())[clear]
        update_err[k] = d.abs().max().item() / lr if d.numel() else 0.0
    worst = dict(reset_rel=max(reset_err.values()),
                 step_rel=max(step_err.values()),
                 loss_rel=max(term_err.values()),
                 grad_rel=max(grad_err.values()),
                 update_lr=max(update_err.values()))
    emit("mesh_reference", card=card, ranks=R, num_envs=N,
         envs_compared=int(keep.sum()), reset_rel_err=reset_err,
         step_rel_err=step_err, edge_m=EDGE_M,
         points_near_edges=int(near.sum()),
         differing_near_edges=listed[:16], minibatch_rows=int(mb1["adv"].shape[0]),
         rank_rows=rows, terms_one_rank={k: v.item()
                                         for k, v in terms1.items()},
         terms_ranks_summed={k: v.item() for k, v in tsum.items()},
         worst=worst, tolerance=dict(reset_rel=STEP_RTOL,
                                     step_rel=STEP_RTOL, loss_rel=LOSS_REL,
                                     grad_rel=GRAD_REL,
                                     update_lr=UPDATE_LR))
    if not (sum(rows) == int(mb1["adv"].shape[0])
            and worst["reset_rel"] <= STEP_RTOL
            and worst["step_rel"] <= STEP_RTOL
            and worst["loss_rel"] <= LOSS_REL
            and worst["grad_rel"] <= GRAD_REL
            and worst["update_lr"] <= UPDATE_LR):
        raise SystemExit(f"mesh_reference: the ranks disagree with the "
                         f"one-rank run: {worst}")
    del env1, agent1, ts, pools
    torch.cuda.empty_cache()


def run_mesh(argv):
    """`python3 -m emloco_tpu_torch.cli.run <argv>` as a child process (its
    ranks are processes of their own): (exit code, its JSON lines, seconds,
    the end of its stderr). Fails when it does not end in MESH_TIMEOUT_S."""
    t = time.time()
    p = subprocess.run([sys.executable, "-m", "emloco_tpu_torch.cli.run",
                        *argv], cwd=_HERE, capture_output=True, text=True,
                       timeout=MESH_TIMEOUT_S)
    lines = [json.loads(x) for x in p.stdout.splitlines()
             if x.startswith("{")]
    return p.returncode, lines, time.time() - t, p.stderr[-3000:]


def rank_lines(phase, code, lines, err, want_launches=None):
    """The ranks' first lines, epoch lines and last lines of a run; fails
    on a non-zero exit, a missing rank or (where given) launch counts other
    than `want_launches` (factor, resolve) on each rank."""
    if code != 0:
        raise SystemExit(f"{phase}: exit code {code}:\n{err}")
    first = sorted((x for x in lines if "backend" in x),
                   key=lambda x: x["rank"])
    last = sorted((x for x in lines if "launches" in x),
                  key=lambda x: x["rank"])
    epochs = [x for x in lines if "epoch" in x and "rank" in x]
    if [x["rank"] for x in first] != list(range(MESH_RANKS)) or \
            [x["rank"] for x in last] != list(range(MESH_RANKS)):
        raise SystemExit(f"{phase}: ranks reported {first} {last}")
    if want_launches is not None:
        for x in last:
            arrow_launches(f"{phase} rank {x['rank']}", x["launches"],
                           *want_launches)
    return first, epochs, last


def cli_mesh(card, out):
    """Phase 47: train-policy over MESH_RANKS ranks, its resume, and
    train-predictor over MESH_RANKS ranks. Returns the launch counts summed
    over the ranks of every run."""
    import torch
    from emloco_tpu_torch import convert
    from emloco_tpu_torch.cli.run import params_digest
    from emloco_tpu_torch.utils.checkpoint import load_pickle, load_pytree
    base = ["train-policy", "--config", PACER, "--mesh", str(MESH_RANKS),
            f"out_dir={out}"]
    code, lines, secs, err = run_mesh([*base, "epochs=2", "save_every=1"])
    first, epochs, last = rank_lines("cli_mesh", code, lines, err, (64, 128))
    ck1 = os.path.join(out, "policy_00000001.ckpt")
    tree, meta1 = load_pytree(ck1)
    digest1 = params_digest(convert.agent_state_dict(tree["params"]))
    rows = jsonl(os.path.join(out, "policy.metrics.jsonl"))
    code2, lines2, secs2, err2 = run_mesh([*base, "--resume", ck1,
                                           "epochs=1"])
    _, epochs2, last2 = rank_lines("cli_mesh resume", code2, lines2, err2,
                                   (32, 64))
    tree2, meta2 = load_pytree(os.path.join(out, "policy_00000002.ckpt"))
    digest2 = params_digest(convert.agent_state_dict(tree2["params"]))
    pout = os.path.join(out, "predictor")
    code3, lines3, secs3, err3 = run_mesh([
        "train-predictor", "--config", JTA_CONFIG, "--mesh",
        str(MESH_RANKS), "epochs=1", "--batches", str(MESH_PRED_STEPS),
        f"out_dir={pout}"])
    _, _, last3 = rank_lines("cli_mesh train-predictor", code3, lines3, err3,
                             (0, 0))
    blob = load_pickle(os.path.join(pout, "predictor_best.ckpt"))
    digest3 = params_digest(convert.transmotion_state_dict(blob["params"]))
    entry = next(x for x in lines3 if "steps_per_s" in x)
    prow = jsonl(os.path.join(pout, "predictor.metrics.jsonl"))
    backend = "nccl" if torch.cuda.device_count() >= MESH_RANKS else "gloo"
    checks = dict(
        backend=all(x["backend"] == backend for x in first),
        ranks_equal=[len({x["params_sha256"] for x in r}) == 1
                     for r in (last, last2, last3)],
        checkpoint_bit_equal=[digest1 == last[0]["params_sha256"],
                              digest2 == last2[0]["params_sha256"],
                              digest3 == last3[0]["params_sha256"]],
        checkpoint_epochs=[meta1.get("epoch"), meta2.get("epoch")],
        epochs=sorted({x["epoch"] for x in epochs}),
        resumed_epochs=sorted({x["epoch"] for x in epochs2}),
        metrics_rows=[rows[0].get("mesh_backend"),
                      prow[0].get("mesh_backend")],
        finite=all(math.isfinite(v) for v in [*rows[0].values(),
                                              *prow[0].values()]
                   if isinstance(v, float)))
    emit("cli_mesh", card=card, ranks=MESH_RANKS, num_envs=1600,
         rank_devices=first[0]["devices"], backends=[x["backend"]
                                                     for x in first],
         epoch_seconds={r: [x["seconds"] for x in epochs if x["rank"] == r]
                        for r in range(MESH_RANKS)},
         resume_epoch_seconds=[x["seconds"] for x in epochs2],
         seconds=[secs, secs2, secs3],
         launches=[x["launches"] for x in last],
         resume_launches=[x["launches"] for x in last2],
         predictor=dict(batch=PRED_BATCH, per_rank=PRED_BATCH // MESH_RANKS,
                        steps=MESH_PRED_STEPS,
                        steps_per_s=entry["steps_per_s"],
                        train_seconds=entry["train_seconds"],
                        traj_loss=entry["traj_loss"]),
         checks=checks)
    if not (checks["backend"] and all(checks["ranks_equal"])
            and all(checks["checkpoint_bit_equal"])
            and checks["checkpoint_epochs"] == [1, 2]
            and checks["epochs"] == [0, 1]
            and checks["resumed_epochs"] == [2]
            and checks["metrics_rows"] == [backend, backend]
            and checks["finite"]):
        raise SystemExit(f"cli_mesh: {checks}")
    return {k: sum(x["launches"][k] for x in (*last, *last2, *last3))
            for k in last[0]["launches"]}


def mesh_phases(card):
    """Phases 45-47; returns the launch counts of the ranks' runs."""
    import tempfile
    kinematics_variants(card)
    mesh_reference(card)
    with tempfile.TemporaryDirectory() as out:
        return {"cli_mesh": cli_mesh(card, out)}


# ---------------------------------------------------------------------------
# 48. the observation options, the MJCF export and the env's betas=
# ---------------------------------------------------------------------------

# control steps before the observations; their card-vs-CPU tolerance (that
# of tests/test_torch_sensors.py: float32 work in the same order, up to a
# few ulps); the crowd groups; neighbours whose distances lie within TIE_M
# may order the other way on the other device; the betas' spread; the MJCF
# numbers' tolerance (5 decimals at most, so 1e-4 is a last-digit change)
OBS_STEPS, OBS_REL, OBS_GROUP, TIE_M = 2, 1e-5, 128, 1e-6
OBS_BETA_STD, MJCF_TOL = 0.3, 1e-4


def mjcf_numbers(xml):
    """(every element's tag and non-numeric attribute tokens, in document
    order; every numeric token) of an MJCF string."""
    import xml.etree.ElementTree as ET
    layout, numbers = [], []
    for el in ET.fromstring(xml).iter():
        for key, value in el.attrib.items():
            for tok in value.split():
                try:
                    numbers.append(float(tok))
                except ValueError:
                    layout.append((el.tag, key, tok))
        layout.append(el.tag)
    return layout, numbers


def obs_options(card):
    """Phase 48: the bench world at NUM_ENVS with bodies built on the card
    from betas N(0, 0.3²) (`PedestrianTerrainEnv(…, betas=)`, held bit-equal
    to build_body_params of them), OBS_STEPS control steps with the
    launch counts read around them; then humanoid_obs_max, amp_obs,
    location_obs and group_obs (groups of OBS_GROUP) of the card's body
    state under each (root_height_obs, upright) pair against the same
    tensors on the CPU, each within OBS_REL of the CPU's largest |value| (a
    group_obs row whose neighbours order the other way by a near tie,
    distances within TIE_M, excused and counted); then to_mjcf of the first
    and the last env's bodies against those of the same betas built on the
    CPU, the same layout and numbers within MJCF_TOL. Returns the launch
    counts."""
    import itertools

    import torch
    from emloco_tpu_torch.envs import PedestrianTerrainEnv, traj_gen
    from emloco_tpu_torch.envs import observations as obs
    from emloco_tpu_torch.kinematics import body_model as bm
    from emloco_tpu_torch.physics import body_frame_state, joint_state, linalg
    from emloco_tpu_torch.rollout import Rollout, build_bench
    t0 = time.time()
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    r = build_bench(NUM_ENVS, dev)
    cfg = r.cfg
    betas = OBS_BETA_STD * torch.randn(
        (NUM_ENVS, 16), generator=torch.Generator(device=dev).manual_seed(48),
        device=dev)
    env = PedestrianTerrainEnv(cfg, r.env.terrain, r.env.motion_lib,
                               device=dev, betas=betas)
    built = bm.build_body_params(betas, device=dev)
    betas_equal = all(
        torch.equal(getattr(env.params, f.name), getattr(built, f.name))
        for f in dataclasses.fields(bm.BodyParams))
    r = Rollout(cfg, env, r.actor, r.norm)
    state = env.reset(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    linalg.reset_launch_counts()
    t = time.time()
    for _ in range(OBS_STEPS):
        state, out, _, _ = r.control_step(state)
    torch.cuda.synchronize()
    steps_s = time.time() - t
    launches = dict(linalg.LAUNCHES)
    want = dict.fromkeys(launches, 0)
    want.update({"cholesky_factor_blocked_t": OBS_STEPS,
                 "cholesky_resolve_blocked_t":
                     OBS_STEPS * cfg.engine.n_substeps})

    ph = state.physics
    pos, rot, vel, ang = body_frame_state(env.model, ph)
    dof_pos, dof_vel = joint_state(env.model, ph)
    samples = traj_gen.fetch_samples(
        state.traj_verts, state.progress.float() * cfg.dt,
        cfg.traj.episode_dur, cfg.num_traj_samples,
        cfg.traj_sample_timestep)
    g = dict(pos=pos, rot=rot, vel=vel, ang=ang, dof_pos=dof_pos,
             dof_vel=dof_vel, key=pos[:, env._key_ids], samples=samples,
             betas=env.params.betas, limb=env.limb_weights)
    c = {k: v.cpu() for k, v in g.items()}

    def observe(x, root_h, upright):
        opts = dict(root_height_obs=root_h, upright=upright)
        root = (x["pos"][:, 0], x["rot"][:, 0])
        return {
            "humanoid_obs_max": obs.humanoid_obs_max(
                x["pos"], x["rot"], x["vel"], x["ang"], betas=x["betas"],
                limb_weights=x["limb"], **opts),
            "amp_obs": obs.amp_obs(
                *root, x["vel"][:, 0], x["ang"][:, 0], x["dof_pos"],
                x["dof_vel"], x["key"], betas=x["betas"],
                limb_weights=x["limb"], **opts),
            "location_obs": obs.location_obs(*root, x["samples"],
                                             upright=upright),
            "group_obs": obs.group_obs(x["pos"], x["vel"], x["rot"][:, 0],
                                       OBS_GROUP, upright=upright)}

    # group rows whose neighbours order the other way on the card
    k = min(5, OBS_GROUP - 1)
    _, nbr_g = obs._nearest_in_group(g["pos"][:, 0], OBS_GROUP, k)
    _, nbr_c = obs._nearest_in_group(c["pos"][:, 0], OBS_GROUP, k)
    d_c, _ = obs._nearest_in_group(c["pos"][:, 0], OBS_GROUP, k + 1)
    reordered = (nbr_g.cpu() != nbr_c).any(-1)
    tie = (d_c.diff(dim=-1) <= TIE_M).any(-1)
    excused = reordered & tie
    near = float((d_c[:, :k] <= 10.0).float().mean())
    widths = {"humanoid_obs_max": obs.SELF_OBS_DIM + 21,
              "amp_obs": obs.AMP_OBS_DIM + 21,
              "location_obs": 2 * cfg.num_traj_samples,
              "group_obs": k * 33}
    errs, bad = {}, []
    for root_h, upright in itertools.product((False, True), repeat=2):
        o_g, o_c = observe(g, root_h, upright), observe(c, root_h, upright)
        for name, og in o_g.items():
            oc = o_c[name]
            a, b = og.cpu().double(), oc.double()
            if name == "group_obs":
                a, b = a[~excused], b[~excused]
            scale = max(b.abs().max().item(), 1e-6)
            err = (a - b).abs().max().item() / scale
            case = f"{name} root_height_obs={root_h} upright={upright}"
            errs[case] = err
            width = widths[name] + (root_h and name in ("humanoid_obs_max",
                                                        "amp_obs"))
            if not (err <= OBS_REL and bool(torch.isfinite(og).all())
                    and tuple(og.shape) == tuple(oc.shape)
                    == (NUM_ENVS, width)):
                bad.append(case)

    cpu_params = bm.build_body_params(betas.cpu(), device=cpu)
    mjcf = {}
    for i in (0, NUM_ENVS - 1):
        x_g, x_c = bm.to_mjcf(env.params, i), bm.to_mjcf(cpu_params, i)
        (lay_g, num_g), (lay_c, num_c) = mjcf_numbers(x_g), mjcf_numbers(x_c)
        same = lay_g == lay_c and len(num_g) == len(num_c)
        mjcf[i] = dict(
            same_layout=same, byte_equal=x_g == x_c, numbers=len(num_g),
            max_abs_err=(max(abs(p - q) for p, q in zip(num_g, num_c))
                         if same else None),
            bodies=x_g.count("<body "), motors=x_g.count("<motor "))
    mjcf_ok = all(m["same_layout"] and m["max_abs_err"] <= MJCF_TOL
                  and m["bodies"] == bm.NUM_BODIES
                  and m["motors"] == bm.NUM_DOF for m in mjcf.values())
    seconds = time.time() - t0
    emit("obs_options", num_envs=NUM_ENVS, steps=OBS_STEPS,
         steps_seconds=round(steps_s, 4), launches=launches,
         betas_equal_build_body_params=betas_equal,
         max_rel_err=errs, tolerance_rel=OBS_REL, group_size=OBS_GROUP,
         group_rows_reordered=int(reordered.sum()),
         group_rows_excused_near_tie=int(excused.sum()), tie_m=TIE_M,
         neighbours_within_max_dist=near, mjcf=mjcf, mjcf_tol=MJCF_TOL,
         finite=bool(torch.isfinite(out.reward).all()), card=card)
    emit("obs_options_seconds", seconds=round(seconds, 3), card=card)
    if launches != want:
        raise SystemExit(f"obs_options: launch counts {launches}, expected "
                         f"{want}")
    if not betas_equal:
        raise SystemExit("obs_options: the env's bodies from betas= differ "
                         "from build_body_params of the same betas")
    if bad:
        raise SystemExit(f"obs_options: card and CPU disagree, or a shape "
                         f"or value is wrong, in {bad}")
    if bool((reordered & ~tie).any()):
        raise SystemExit("obs_options: group_obs neighbours order "
                         "differently with no near tie")
    if not mjcf_ok:
        raise SystemExit(f"obs_options: to_mjcf differs from the CPU's: "
                         f"{mjcf}")
    return launches


def device_ms(fn, iters):
    """Device ms a call with the calls queued behind a sleep, so that they
    run back to back however slow the host is."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def norm_ulp(out, args):
    """The optimizer kernel's step `out` on `args` (clip_adam's) is the plain
    version's on the gradients clipped at a norm within 2 ulp of the norm
    summed in float64: that norm's distance in ulp from the plain version's
    own (None where no such norm gives `out` bit for bit)."""
    import torch
    from emloco_tpu_torch.learning import fused_adam as fa
    grads, params, count, mu, nu, max_norm, lr, decay, guard = args
    dtype = next(iter(grads.values())).dtype
    plain = torch.sqrt(sum((g * g).sum() for g in grads.values()))
    exact = torch.sqrt(sum((g * g).double().sum()
                           for g in grads.values()).to(dtype))
    far = torch.full_like(exact, math.inf)
    cands, up, down = [exact], exact, exact
    for _ in range(2):
        up, down = torch.nextafter(up, far), torch.nextafter(down, -far)
        cands += [up, down]
    for c in cands:
        at_c = {k: torch.where(c < max_norm, g, g / c * max_norm)
                for k, g in grads.items()}
        ref = fa.clip_adam_plain(at_c, params, count, mu, nu, math.inf, lr,
                                 decay, guard)
        if all(tree_equal(a, b) for a, b in
               zip((out[0], out[2], out[3]), (ref[0], ref[2], ref[3]))):
            return ((c - plain).abs() / (torch.nextafter(plain, far)
                                         - plain)).item()
    return None


def clip_adam_phase(card):
    """49. The optimizer's kernel against its plain version, and its
    times, at the training network's and TransMotion's leaves."""
    import torch
    from emloco_tpu_torch.learning import fused_adam as fa
    from emloco_tpu_torch.prediction.presets import configs
    from emloco_tpu_torch.prediction.train import PredictorTrainer
    from emloco_tpu_torch.rollout import build_train_bench
    dev = torch.device("cuda")
    agent, ts = build_train_bench(16, dev)
    mcfg, pcfg = configs("jta")
    trainer = PredictorTrainer(mcfg, pcfg, device=dev)
    nets = {"agent": (ts.params, agent.tx),
            "predictor": (trainer.init(0).params, trainer.tx)}
    del agent, ts
    for name, (params, tx) in nets.items():
        gen = torch.Generator(device=dev).manual_seed(CLIP_ADAM_SEED)
        n = sum(v.numel() for v in params.values())

        def draw(scale):
            return {k: torch.randn(v.shape, generator=gen, device=dev)
                    * scale for k, v in params.items()}

        mu, nu = draw(1e-3), {k: v.abs() for k, v in draw(1e-4).items()}
        count = torch.tensor(5, dtype=torch.int32, device=dev)
        decayed = (2, 0.5)
        checks = {}
        fa.reset_launch_counts()
        calls = 0
        for label, norm, decay, guard in (
                ("unclipped", 0.5, None, False),
                ("unclipped_guard", 0.5, None, True),
                ("unclipped_decay", 0.5, decayed, False),
                ("clipped", 30.0, decayed, True)):
            grads = draw(norm * tx.max_norm / math.sqrt(n))
            args = (grads, params, count, mu, nu, tx.max_norm, tx.lr, decay,
                    guard)
            k = fa.clip_adam(*args)
            again = fa.clip_adam(*args)
            calls += 2
            p = fa.clip_adam_plain(*args)
            bit = (torch.equal(k[1], p[1]) and torch.equal(k[4], p[4])
                   and all(tree_equal(a, b) for a, b in
                           zip((k[0], k[2], k[3]), (p[0], p[2], p[3]))))
            checks[label] = dict(
                bit_equal=bit,
                norm_ulp=0.0 if bit else norm_ulp(k, args),
                deterministic=all(tree_equal(a, b) for a, b in zip(
                    (k[0], k[2], k[3]), (again[0], again[2], again[3]))))
        grads[next(iter(grads))].view(-1)[0] = float("nan")
        k = fa.clip_adam(grads, params, count, mu, nu, tx.max_norm, tx.lr,
                         decayed, True)
        calls += 1
        checks["nan_guard"] = dict(
            kept=(tree_equal(k[0], params) and tree_equal(k[2], mu)
                  and tree_equal(k[3], nu) and torch.equal(k[1], count)
                  and not bool(k[4])))
        launches = fa.LAUNCHES["clip_adam"]
        grads = draw(0.5 * tx.max_norm / math.sqrt(n))
        args = (grads, params, count, mu, nu, tx.max_norm, tx.lr, decayed,
                True)
        ms = device_ms(lambda: fa.clip_adam(*args), 20)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fa.clip_adam(*args)
            torch.cuda.synchronize()
        pass_us = {name: e.device_time_total / e.count
                   for e in prof.key_averages()
                   for name in ("clip_adam_norm", "clip_adam_step")
                   if name in e.key}
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(20):
            fa.clip_adam(*args)
        host_ms = (time.perf_counter() - t) / 20 * 1e3
        torch.cuda.synchronize()
        plain_ms = time_ms(lambda: fa.clip_adam_plain(*args), 3)
        leaves = [v.clone() for v in params.values()]
        for leaf, g in zip(leaves, grads.values()):
            leaf.grad = g
        adam = torch.optim.Adam(leaves, lr=tx.lr, fused=True)
        library_ms = device_ms(adam.step, 20)
        nbytes = 7 * 4 * n
        bound_ms = nbytes / HBM_BYTES_S * 1e3
        emit("clip_adam", card=card, net=name, leaves=len(params),
             params=n, checks=checks, launches=launches, calls=calls, ms=ms,
             pass_us=pass_us, host_ms=host_ms, plain_ms=plain_ms,
             library_ms=library_ms, bytes=nbytes, bound_ms=bound_ms,
             bound_share=bound_ms / ms)
        bad = [c for c, v in checks.items()
               if not (v.get("kept", True) and v.get("deterministic", True)
                       and (v.get("bit_equal", True) or c == "clipped")
                       and v.get("norm_ulp", 0.0) is not None
                       and v.get("norm_ulp", 0.0) <= NORM_ULP)]
        if bad or launches != calls:
            raise SystemExit(f"clip_adam on {name}: checks {bad} failed, or "
                             f"{launches} fused steps counted for {calls}: "
                             f"{checks}")


def tree_diff(a, b) -> float:
    """The largest |a − b| over two trees of tensors of one structure
    (inf where a shape differs)."""
    from torch.utils._pytree import tree_leaves
    worst = 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
        if x.shape != y.shape:
            return math.inf
        if x.numel():
            worst = max(worst, (x.double() - y.double()).abs().max().item())
    return worst


def graph_run(agent, ts, mbs, eager):
    """`_update_minibatch` on each of `mbs` in turn from `ts`'s parameters
    and optimizer state, the loss graphed (the agent's own call) or eager
    (`_compute_loss_and_grads` in its place): what each `_loss_and_grads`
    returned and the parameters and metrics after each (moved to the
    host), the counters' advance, seconds a call (synchronized), whether
    the first call's outputs stood unchanged through the later calls, and
    the GB the run's peak added to what was allocated before it."""
    import torch
    from emloco_tpu_torch.learning import amp_agent, fused_adam, networks
    from torch.utils._pytree import tree_map
    inner = (agent._compute_loss_and_grads if eager
             else agent._loss_and_grads)
    kept = []

    def record(*a, **kw):
        out = inner(*a, **kw)
        kept.append(out)
        return out
    fused_adam.reset_launch_counts()
    networks.reset_conv_counts()
    amp_agent.reset_loss_graph_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    allocated = torch.cuda.memory_allocated()
    params, opt = ts.params, ts.opt_state
    steps, seconds, first = [], [], None
    agent._loss_and_grads = record
    try:
        for mb in mbs:
            t = time.perf_counter()
            params, opt, m = agent._update_minibatch(params, opt, *mb)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t)
            if first is None:
                first = tree_map(torch.clone, kept[0])
            steps.append((params, m))
    finally:
        del agent._loss_and_grads
    out = dict(seconds=seconds, first_kept=tree_diff(kept[0], first) == 0.0,
               fused=fused_adam.LAUNCHES["clip_adam"],
               conv=dict(networks.CONV_ENCODER),
               loss_graph=dict(amp_agent.LOSS_GRAPH),
               peak_added_gb=(torch.cuda.max_memory_allocated() - allocated)
               / 2 ** 30)
    # on the host, so that the next run's peak starts where this one did
    out.update(kept=tree_map(lambda x: x.cpu(), kept),
               steps=tree_map(lambda x: x.cpu(), steps))
    return out


def replay_kernels(agent, ts, mb, eager):
    """One `_update_minibatch` under torch.profiler (a replay where the
    agent has the graph; eager with `_compute_loss_and_grads` in place of
    the call): its device ms and count of GEMM and cuDNN conv kernels, and
    the replays it counted."""
    import re
    import torch
    from emloco_tpu_torch.learning import amp_agent
    if eager:
        agent._loss_and_grads = agent._compute_loss_and_grads
    replays = amp_agent.LOSS_GRAPH["replays"]
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            agent._update_minibatch(ts.params, ts.opt_state, *mb)
            torch.cuda.synchronize()
    finally:
        if eager:
            del agent._loss_and_grads
    ops = [(e.key, e.device_time_total, e.count) for e in prof.key_averages()
           if e.device_time_total > 0]
    return dict(device_ms=sum(t for _, t, _ in ops) * 1e-3,
                gemm=sum(n for k, _, n in ops if re.search("gemm", k)),
                conv=sum(n for k, _, n in ops
                         if re.search(CONV_KERNELS, k)),
                replays=amp_agent.LOSS_GRAPH["replays"] - replays)


def loss_graph_runs(agent, ts, mbs):
    """graph_run graphed, eager and eager again, and their differences:
    (the runs, graph against eager, eager against itself)."""
    runs = {mode: graph_run(agent, ts, mbs, mode != "graph")
            for mode in ("graph", "eager", "eager_again")}

    def diff(x, y):
        return dict(
            returned=max(tree_diff(a, b) for a, b in
                         zip(runs[x]["kept"], runs[y]["kept"])),
            params=max(tree_diff(a[0], b[0]) for a, b in
                       zip(runs[x]["steps"], runs[y]["steps"])),
            metrics=max(tree_diff(a[1], b[1]) for a, b in
                        zip(runs[x]["steps"], runs[y]["steps"])))
    return runs, diff("graph", "eager"), diff("eager", "eager_again")


def loss_graph_phase(card):
    """50. The minibatch's loss and gradients as a CUDA graph against the
    eager call (the docstring's head). cuDNN's default convolution
    algorithms sum the conv weights' gradients in no fixed order, so the
    sept_cnn agent's eager run differs from itself: it is held bit for bit
    with cuDNN's deterministic algorithms, and with the default ones within
    NONDETERMINISTIC_ROOM times the eager run's own worst difference."""
    import itertools
    import torch
    from emloco_tpu_torch.rollout import (CROWD_AMP, CROWD_ENV, TRAIN_AMP,
                                          build_train_bench)
    amp = dataclasses.replace(TRAIN_AMP, amp_batch_size=BENCH_AMP_BATCH)
    for net, a, env, modes in (
            ("sept", amp, {}, (False,)),
            ("sept_cnn", dataclasses.replace(amp, **CROWD_AMP), CROWD_ENV,
             (True, False))):
        agent, ts = build_train_bench(TRAIN_ENVS, "cuda", 0, a, **env)
        ts, batch, last_obs = agent.rollout(ts)
        ts, pools = agent.prepare(ts, batch, last_obs)
        del batch
        mbs = [x[:4] for x in itertools.islice(
            agent.minibatches(pools, ts.rng), LOSS_GRAPH_CALLS)]
        n = len(mbs)
        for deterministic in modes:
            torch.backends.cudnn.deterministic = deterministic
            try:
                runs, vs_eager, eager_self = loss_graph_runs(agent, ts, mbs)
                kernels = {mode: replay_kernels(agent, ts, mbs[0],
                                                mode == "eager")
                           for mode in ("graph", "eager")}
            finally:
                torch.backends.cudnn.deterministic = False
            g, e = runs["graph"], runs["eager"]
            emit("loss_graph", card=card, net=net, calls=n,
                 cudnn_deterministic=deterministic,
                 rows=int(mbs[0][0]["adv"].shape[0]),
                 graph_vs_eager=vs_eager, eager_vs_eager=eager_self,
                 bit_equal=max(vs_eager.values()) == 0.0,
                 loss_graph=g["loss_graph"], fused=[g["fused"], e["fused"]],
                 conv_encoder=[g["conv"], e["conv"]],
                 first_kept=g["first_kept"], first_call_s=g["seconds"][0],
                 ms_a_call=dict(graph=1e3 * sum(g["seconds"][1:]) / (n - 1),
                                eager=1e3 * sum(e["seconds"][1:]) / (n - 1)),
                 peak_added_gb=dict(graph=g["peak_added_gb"],
                                    eager=e["peak_added_gb"]),
                 profiled=kernels)
            bad = []
            worst, own = max(vs_eager.values()), max(eager_self.values())
            if worst > NONDETERMINISTIC_ROOM * own:
                bad.append("graph differs from eager beyond eager's own "
                           "differences" if own else "graph not bit-equal "
                           "to eager")
            if g["loss_graph"] != dict(captures=1, replays=n, eager=0):
                bad.append(f"counted {g['loss_graph']}")
            if not g["first_kept"]:
                bad.append("a later replay overwrote the first call's "
                           "outputs")
            if g["fused"] != e["fused"] or g["conv"] != e["conv"]:
                bad.append("fused_adam or CONV_ENCODER counted otherwise")
            kg = kernels["graph"]
            if kg["replays"] != 1 or not kg["gemm"] or (
                    net == "sept_cnn" and not kg["conv"]):
                bad.append(f"the profiled replay shows {kg}")
            if bad:
                raise SystemExit(f"loss_graph on {net} (cuDNN deterministic "
                                 f"{deterministic}): {bad}")
        del agent, ts, pools, mbs, runs


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device, nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from emloco_tpu_torch import build
    from emloco_tpu_torch.physics import EngineConfig, linalg
    from emloco_tpu_torch.physics import reduced as R
    from emloco_tpu_torch.rollout import build_bench

    dev = torch.device("cuda")
    # the networks' float32 GEMMs and convs in full float32, not TF32 (the
    # physics step sets this for itself)
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    torch.backends.cudnn.conv.fp32_precision = "ieee"

    # 1. build --------------------------------------------------------------
    t = time.time()
    lib_path, log = build.build()
    build.load()
    arrow = (R._ARROW_CHUNKS, R._ARROW_LIMBS, R._ARROW_S)
    emit("build", seconds=round(time.time() - t, 3),
         library=os.path.relpath(lib_path),
         ptxas=[ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln or "Compiling" in ln],
         shared_memory_kernels={
             "cholesky_factor_blocked_t": dict(
                 threads_per_env=32, **linalg.factor_launch_shape(*arrow)),
             "cholesky_resolve_blocked_t, cholesky_solve_blocked_t and "
             "cholesky_resolve_blocked":
                 dict(threads_per_env=32,
                      **linalg.solve_launch_shape(*arrow)),
             "cholesky_solve_soa_t": dict(
                 threads_per_env=32, **linalg.dense_launch_shape(R.NU))},
         gram_diag={"bf16_rows": linalg.gram_launch_shape(R.NU, True),
                    "float32_rows": linalg.gram_launch_shape(R.NU, False)})

    # 2. card ---------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit("card", nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0))

    # the env at the bench configuration (its reset state feeds phase 3)
    t = time.time()
    rollout = build_bench(NUM_ENVS, dev)
    cfg, env = rollout.cfg, rollout.env
    state = env.reset(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    emit("setup", seconds=round(time.time() - t, 3), num_envs=NUM_ENVS,
         obs_dim=cfg.obs_dim)

    # 3. kernels against their plain versions -------------------------------
    pattern = linalg.arrow_pattern(R._ARROW_LIMBS, R._ARROW_S, R.NU)
    gen = torch.Generator(device=dev).manual_seed(2)
    (G, W, ground, *_rest) = R._contact_and_jacobians(
        env.model, env.terrain, state.physics, cfg.engine)
    diag = _rest[5]
    A_real = (R._assemble_lhs_merged(env.model, G, W, diag, ground)
              + 1e-8 * torch.eye(R.NU, device=dev)[:, :, None]).contiguous()
    # the Gram's inputs from the same reset state, for phases 8 and 9
    gcases = gram_inputs(env, state, cfg.engine, gen)
    # its own generator, so the later phases' draws stay as they were
    gen_dense = torch.Generator(device=dev).manual_seed(3)
    cases = {
        "real_lhs": (A_real, torch.randn((R.NU, NUM_ENVS), generator=gen,
                                         device=dev)),
        "random_spd": (random_arrow_spd(NUM_ENVS, arrow, pattern, gen, dev),
                       torch.randn((R.NU, NUM_ENVS), generator=gen,
                                   device=dev)),
        "ragged": (random_arrow_spd(RAGGED_ENVS, arrow, pattern, gen, dev),
                   torch.randn((R.NU, RAGGED_ENVS), generator=gen,
                               device=dev)),
        "dense_spd": (dense_spd(NUM_ENVS, R.NU, gen_dense, dev),
                      torch.randn((R.NU, NUM_ENVS), generator=gen_dense,
                                  device=dev)),
    }
    errs = {"factor": 0.0, "resolve": 0.0}
    for name, (A, b) in cases.items():
        L_k = linalg.cholesky_factor_blocked_t(A, *arrow)
        L_p = linalg.factor_blocked_plain(A, *arrow)
        x_k = linalg.cholesky_resolve_blocked_t(L_k, b, *arrow)
        x_p = linalg.resolve_blocked_plain(L_p, b, *arrow)
        torch.cuda.synchronize()
        eL, rL = rel_err(L_k, L_p)
        ex, rx = rel_err(x_k, x_p)
        finite = bool(torch.isfinite(L_k).all() and torch.isfinite(x_k).all())
        emit("kernels", case=name, factor_max_abs_err=eL,
             factor_max_rel_err=rL, resolve_max_abs_err=ex,
             resolve_max_rel_err=rx, tolerance_rel=KERNEL_RTOL,
             factor_bit_equal=bool(torch.equal(L_k, L_p)),
             resolve_bit_equal=bool(torch.equal(x_k, x_p)), finite=finite)
        if (not finite or rL > KERNEL_RTOL or rx > KERNEL_RTOL
                or not torch.equal(L_k, L_p) or not torch.equal(x_k, x_p)):
            raise SystemExit(f"kernel disagrees with its plain version "
                             f"on {name}: factor {rL:.3g} (bit-equal "
                             f"{torch.equal(L_k, L_p)}), resolve {rx:.3g} "
                             f"(bit-equal {torch.equal(x_k, x_p)})")
        errs["factor"] = max(errs["factor"], eL)
        errs["resolve"] = max(errs["resolve"], ex)

    A, b = cases["real_lhs"]
    L = linalg.cholesky_factor_blocked_t(A, *arrow)
    A_bm = A.permute(2, 0, 1).contiguous()
    L_bm = torch.linalg.cholesky(A_bm)
    b_bm = b.T.contiguous()[:, :, None]
    times = {
        "factor": dict(
            ms=time_ms(lambda: linalg.cholesky_factor_blocked_t(A, *arrow),
                       20),
            plain_ms=time_ms(lambda: linalg.factor_blocked_plain(A, *arrow),
                             3),
            library_ms=time_ms(lambda: torch.linalg.cholesky(A_bm), 20)),
        "resolve": dict(
            ms=time_ms(lambda: linalg.cholesky_resolve_blocked_t(L, b, *arrow),
                       20),
            plain_ms=time_ms(
                lambda: linalg.resolve_blocked_plain(L, b, *arrow), 3),
            library_ms=time_ms(lambda: torch.cholesky_solve(b_bm, L_bm), 20)),
    }
    f_flops, r_flops, n_pattern = arrow_work(pattern)
    M = R.NU
    # least bytes each function must move: the factor reads A's in-pattern
    # lower triangle and writes the dense L; the resolve reads L's in-pattern
    # lower triangle and b, and writes x
    bounds = {
        "factor": ((n_pattern + M * M) * 4 * NUM_ENVS, f_flops * NUM_ENVS),
        "resolve": ((n_pattern + 2 * M) * 4 * NUM_ENVS, r_flops * NUM_ENVS),
    }
    emit("kernel_times", card=card, **{k: v for k, v in times.items()},
         bytes={k: v[0] for k, v in bounds.items()},
         flops={k: v[1] for k, v in bounds.items()})

    # 4. main path ----------------------------------------------------------
    state, _, _, _ = rollout.control_step(state)   # warm-up
    torch.cuda.synchronize()
    linalg.reset_launch_counts()
    t = time.time()
    finite = True
    for _ in range(MAIN_STEPS):
        state, out, o, mu = rollout.control_step(state)
        finite &= bool(torch.isfinite(o).all() and torch.isfinite(mu).all())
    torch.cuda.synchronize()
    dt = time.time() - t
    launches = dict(linalg.LAUNCHES)
    ph = state.physics
    finite &= all(bool(torch.isfinite(v).all()) for v in (
        ph.u, ph.body_x, ph.body_q, ph.contact_force, out.reward))
    shapes_ok = (tuple(out.obs.shape) == (NUM_ENVS, cfg.obs_dim)
                 and tuple(out.amp_obs.shape)
                 == (NUM_ENVS, cfg.num_amp_obs_steps * cfg.amp_obs_per_step))
    emit("main", steps=MAIN_STEPS, num_envs=NUM_ENVS, seconds=round(dt, 4),
         env_steps_per_s=NUM_ENVS * MAIN_STEPS / dt, card=card,
         launches=launches, finite=finite, shapes_ok=shapes_ok,
         mean_reward=out.reward.mean().item(),
         done_frac=out.done.float().mean().item())
    want = dict.fromkeys(launches, 0)
    want.update({"cholesky_factor_blocked_t": MAIN_STEPS,
                 "cholesky_resolve_blocked_t":
                     MAIN_STEPS * cfg.engine.n_substeps})
    if launches != want:
        raise SystemExit(f"launch counts {launches}, expected {want}")
    if not (finite and shapes_ok):
        raise SystemExit("main path produced non-finite values or wrong "
                         "shapes")

    # 5. reference: one step at 8 envs, card vs CPU -------------------------
    card_vs_cpu("reference", cfg, env, gen)

    # 6. the solver kernels against their plain versions --------------------
    errs.update(solver_kernels(cases, arrow))

    # 7. their times --------------------------------------------------------
    times.update(solver_times(A, b, L, arrow))
    dense = np.tril(np.ones((M, M), bool))
    d_factor, d_resolve, n_dense = arrow_work(dense)
    bounds.update({
        "solve": ((n_pattern + 2 * M) * 4 * NUM_ENVS,
                  (f_flops + r_flops) * NUM_ENVS),
        "resolve_bm": ((n_pattern + 2 * M) * 4 * NUM_ENVS,
                       r_flops * NUM_ENVS),
        "solve_soa": ((n_dense + 2 * M) * 4 * NUM_ENVS,
                      (d_factor + d_resolve) * NUM_ENVS),
        "to_env_last": (2 * M * M * 4 * NUM_ENVS, 0),
    })
    emit("solver_times", card=card,
         **{k: times[k] for k in ("solve", "resolve_bm", "solve_soa",
                                  "to_env_last")},
         bytes={k: v[0] for k, v in bounds.items()},
         flops={k: v[1] for k, v in bounds.items()})

    # 8. the Gram kernel against its plain version --------------------------
    errs["gram_diag"] = gram_kernels(gcases)

    # 9. its times ----------------------------------------------------------
    times["gram_diag"], (g_bytes, g_flops, g_peak) = gram_times(
        *gcases["real_bf16"])
    f32_rows, f32_bound = gram_times(*gcases["real_f32"])
    engine_rows = gcases["real_bf16"]          # phase 12's second input
    del gcases
    bounds["gram_diag"] = (g_bytes, g_flops)
    peaks = {"gram_diag": g_peak}
    for t, (nb, nf, pk) in ((times["gram_diag"], (g_bytes, g_flops, g_peak)),
                            (f32_rows, f32_bound)):
        bound_ms = max(nb / HBM_BYTES_S, nf / pk) * 1e3
        t.update(bound_ms=bound_ms, bound_share=bound_ms / t["ms"])
    emit("gram_times", card=card, gram_diag=times["gram_diag"],
         bytes=g_bytes, flops=g_flops, flop_peak=g_peak,
         f32_rows=dict(f32_rows, bytes=f32_bound[0], flops=f32_bound[1],
                       flop_peak=f32_bound[2]))

    # 10. the engine's other solver and assembly paths ----------------------
    by_path = {"main": launches}
    for name, kw, per_step in PATHS:
        by_path[name], _ = drive_path(
            rollout.with_engine(EngineConfig(**kw)), name, per_step, card,
            engine=kw)

    # 11. the training epoch ------------------------------------------------
    agent, first_update, by_path["train"] = train(card)

    # 12. one update on the card against the CPU -----------------------------
    main_reference(agent, first_update)
    del agent, first_update

    # 13. the LocoVal epoch -------------------------------------------------
    trainer, last_update, by_path["value"] = value(card)

    # 14. one valuenet update and the EmLoco loss, card against CPU ---------
    value_reference(trainer, last_update)
    del trainer, last_update

    # 15. the LocoVal entry points ------------------------------------------
    plausibility(card)

    # 16. reference on the other paths --------------------------------------
    for kw in REFERENCES:
        card_vs_cpu("reference_implicit",
                    dataclasses.replace(cfg, engine=EngineConfig(**kw)), env,
                    gen, engine=kw)

    # 17. the probe's kernels against their plain version -------------------
    pcases = probe_inputs(engine_rows, dev)
    del engine_rows
    errs.update(probe_kernels(pcases))

    # 18. their times, then the probe itself --------------------------------
    p_times, (p_bytes, p_flops) = probe_times(*pcases["probe_seed0"])
    del pcases
    times.update(p_times)
    for key in p_times:
        bounds[key] = (p_bytes, p_flops)
        peaks[key] = BF16_TC_FLOP_S
    p_bound = max(p_bytes / HBM_BYTES_S, p_flops / BF16_TC_FLOP_S) * 1e3
    for t in p_times.values():
        t.update(bound_ms=p_bound, bound_share=p_bound / t["ms"])
    p_times["gram_dual_batched"]["bound_share_block32"] = (
        p_bound / p_times["gram_dual_batched"]["ms_block32"])
    emit("probe_times", card=card, **p_times, bytes=p_bytes, flops=p_flops,
         flop_peak=BF16_TC_FLOP_S)
    by_path["probe"], _ = run_probe()

    # 19. the sensor variants of the control step ---------------------------
    by_path.update({f"sensor_{k}": v
                    for k, v in sensor_paths(card).items()})

    # 20. the crowd training epoch -------------------------------------------
    agent, ts, first, by_path["crowd_train"] = crowd_train(card)

    # 21. one crowd update and query_value_gradient, card against CPU --------
    crowd_reference(agent, first)
    qvg = crowd_query_value_gradient(agent, ts)
    emit("crowd_reference", query_value_gradient=qvg)
    if not (qvg["finite"] and qvg["grad_nonzero"]
            and qvg["value_max_rel_err"] <= QVG_REL
            and qvg["grad_max_rel_err"] <= QVG_REL):
        raise SystemExit(f"crowd_reference: query_value_gradient disagrees "
                         f"with the CPU's: {qvg}")
    del agent, ts, first

    # 22. the hidden_bf16 training epoch -------------------------------------
    by_path["bf16_train"] = bf16_train(card)

    # 23. the perturbations and hard-negative sampling -----------------------
    by_path["perturbations"] = perturbations(card)

    # 24-25. the contact variants, and gram_diag at their row counts --------
    contact_launches, contact_rows = contact_paths(rollout, card)
    by_path.update(contact_launches)
    errs["gram_diag"] = max(errs["gram_diag"],
                            contact_kernels(contact_rows, card))
    del contact_rows

    # 26. the contact variants, card against CPU ----------------------------
    reference_contacts(cfg, env, gen)

    # 27-28. the getup and hand training epochs -----------------------------
    by_path["getup_train"] = getup_train(card)
    by_path["hand_train"] = hand_train(card)

    # 29. policy checkpoints ------------------------------------------------
    by_path["policy_checkpoint"] = policy_checkpoint(card)

    # 30-33. the trajectory predictor ---------------------------------------
    trainer, vp, scenes = predictor_setup()
    ts, batch, by_path["predictor_train"] = predictor_train(
        card, trainer, vp, scenes)
    predictor_reference(trainer, ts, batch, vp)
    by_path["predictor_eval"] = predictor_eval(card, trainer, ts, vp)
    by_path["predictor_paths"] = predictor_paths(card, vp, scenes)
    del trainer, ts

    # 34-36. the EqMotion baseline ------------------------------------------
    eq_vp = eq_vnet()
    eq_states, by_path["eqmotion_train"] = eqmotion_train(card, eq_vp)
    eqmotion_reference(eq_states, eq_vp)
    by_path["eqmotion_eval"] = eqmotion_eval(card, eq_states, eq_vp)
    del eq_states

    # 37. policy evaluation -------------------------------------------------
    by_path["eval_policy"], by_path["rollout_with_rewards"] = (
        eval_policy_phase(card))

    # 38. the prediction tools ----------------------------------------------
    by_path["prediction_tools"] = prediction_tools(card, vp)

    # 39-44. the entry point over the YAML configs --------------------------
    by_path.update(cli_phases(card))

    # 45-47. SMPL, retargeting, the importers; data parallelism over ranks --
    by_path.update(mesh_phases(card))

    # 48. the observation options, MJCF export and the env's betas= -------
    by_path["obs_options"] = obs_options(card)

    # 49. the optimizer's kernel -------------------------------------------
    clip_adam_phase(card)

    # 50. the minibatch's loss and gradients as a CUDA graph ----------------
    loss_graph_phase(card)

    # summary ---------------------------------------------------------------
    kernels = []
    for key, name, source, replaces in KERNELS:
        nbytes, nflops = bounds[key]
        peak = peaks.get(key, F32_FLOP_S)
        t_bytes = nbytes / HBM_BYTES_S * 1e3
        t_ops = nflops / peak * 1e3
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"emloco_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": sum(c[name] for c in by_path.values()),
            "launches_by_path": {p: c[name] for p, c in by_path.items()
                                 if c[name]},
            "max_abs_err": errs[key], "ms": times[key]["ms"],
            "plain_ms": times[key]["plain_ms"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_flop_peak": peak,
            "library_ms": times[key]["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
