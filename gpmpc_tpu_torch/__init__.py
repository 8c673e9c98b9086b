"""gpmpc_tpu_torch: the PyTorch/CUDA port of gpmpc_tpu (GP-MPC, data-efficient
RL with probabilistic model predictive control) for NVIDIA Hopper.

This slice runs the f32 steady-state planning step of the pendulum workload
(``controllers.planner.Planner``) with hand-written CUDA kernels for the
moment-matching covariance core and the Gram matrix (``ops``). Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``, where every
kernel is replaced by its plain PyTorch twin. Importing the package sets no
global state and builds nothing; the kernels are compiled at first use.
"""
