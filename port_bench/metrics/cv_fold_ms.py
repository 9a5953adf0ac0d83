"""Cross-validation: ms per call in ``models/cv.py::_fold_sweep`` (every fold's
set-up, solve and own-fold predictors; traced run, synced at each
edge)."""

SPANS = {"cv_fold": [("admm_tpu_torch.models.cv", "_fold_sweep")]}


def read(ctx):
    return ctx.span_ms_per_call("cv_fold")
