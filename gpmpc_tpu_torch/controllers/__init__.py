"""L-BFGS-B optimizer and the MPC planner."""
