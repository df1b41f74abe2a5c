"""emloco_tpu_torch — the PyTorch + CUDA port of emloco_tpu for NVIDIA Hopper.

The JAX package `emloco_tpu` is the reference; this package mirrors its
subpackage and module names so each counterpart is found at the same relative
path. It imports torch and numpy only: never jax, flax or emloco_tpu.

Subpackages
-----------
ops          quaternion / rotation algebra on tensors
kinematics   skeleton tree, forward kinematics, body model, motion library,
             skeleton and rollout plots
physics      reduced-coordinate engine (TGS and implicit substeps, env-last
             or batch-major), terrain, the solver kernels' wrappers and
             plain versions
envs         pedestrian-terrain env: reset, observe, step, the mirror of an
             observation, the AMP demo fetch
learning     running normalization, the AMPSept network's four heads, the
             PPO + AMP agent (amp_agent), the LocoVal function
             (ValuePoseNet) and its trainer (value_train), the evaluation
             players (players: rollouts with rewards, value plots, GIFs)
analysis     LocoVal probes: score, rank, sample and optimize trajectories,
             and animate an optimization
prediction   trajectory prediction: metrics, datasets (synthetic scenes,
             ndjson exports), the TransMotion and LSTM predictors, the
             trainer with the EmLoco loss, evaluation with the LocoVal
             filter, the presets of configs/*_predictor.yaml and
             jta_lstm.yaml; the EqMotion baseline (compact and
             architecture-exact), plots, bank export and the hyper-sweep
utils        checkpoints in the JAX package's pickle format, read without
             the JAX package (policies, valuenets, predictors)
csrc         the CUDA kernels; build.py compiles them with nvcc at first use
convert      JAX-package objects (as numpy pytrees) → this package's
             objects, and back to the flax layout for the files it writes
rollout      the env and actor at the bench configuration; the control step;
             the agent and the LocoVal trainer at the bench's training
             configuration
train        the training entry point: python3 -m emloco_tpu_torch.train
             (policy checkpoints with --out, --resume)
train_value  the LocoVal training entry point (--policy, --resume)
optimize_traj  trajectory optimization against a valuenet checkpoint
train_predictor, eval_predictor  the predictor's training (EmLoco loss)
             and evaluation (LocoVal filter, --plots) entry points
train_eqmotion  EqMotion on ETH-UCY with the EmLoco loss and the filter
eval_policy  value prediction on rollouts, the four-condition grid
tune_predictor, visualize_pred  the hyper-sweep and comparison plots
profile_step where a control step's, a training epoch's, a LocoVal
             epoch's or a predictor train step's time goes on the card
scripts      the Gram-layout probe, port of scripts/gram_kernel_probe.py

Every entry point takes `device=None`, which means CUDA; the CPU runs only
when the caller asks for it with `device="cpu"`.
"""

__version__ = "0.1.0"
