from .sharding import build_sharded_plan_fn, build_sharded_train_fn, dryrun_training_step, make_mesh

__all__ = ["build_sharded_plan_fn", "build_sharded_train_fn", "dryrun_training_step", "make_mesh"]
