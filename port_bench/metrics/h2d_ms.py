"""Entry points: ms per call in the numpy -> device copies of
``models/lasso.py::_as_data``/``_as_tensor`` and ``models/cv.py``'s own
``_as_tensor`` binding (traced run, synced at each edge)."""

SPANS = {"h2d": [("admm_tpu_torch.models.lasso", "_as_data"),
                 ("admm_tpu_torch.models.lasso", "_as_tensor"),
                 ("admm_tpu_torch.models.cv", "_as_tensor")]}


def read(ctx):
    return ctx.span_ms_per_call("h2d")
