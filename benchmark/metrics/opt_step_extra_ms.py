"""opt_step_extra_ms: within each bucket, the mean device time of the
micro-steps that carry a BertAdam step minus the mean of those that do
not, weighted by the bucket's share; CUDA events around each train_step
call of the traced window."""

from benchmark.kinds.train import opt_step_extra_ms


def read(run):
    return opt_step_extra_ms(run.get("steps", []))
