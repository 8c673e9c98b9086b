"""gpmpc_tpu_torch: the PyTorch/CUDA port of gpmpc_tpu (GP-MPC, data-efficient
RL with probabilistic model predictive control) for NVIDIA Hopper.

It runs the steady-state planning step of the pendulum workload
(``controllers.planner.Planner``) in f32, in f64, and in mixed mode (an f64
master with a double-float32 rollout, ``Planner(spec, dtype=torch.float32,
master_dtype=torch.float64)``), with hand-written CUDA kernels for the
moment-matching covariance core (f32 and df32) and the Gram matrix
(``ops``). Entry points run on ``cuda`` unless the caller passes
``device="cpu"``, where every kernel is replaced by its plain PyTorch twin.
Importing the package sets no global state and builds nothing; the kernels
are compiled at first use.
"""
