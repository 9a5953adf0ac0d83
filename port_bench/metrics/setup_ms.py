"""Set-up of a fit: ms per call in ``standardize``, the lambda grid and
``_tall_setup``/``_wide_setup`` (the Gram matrix or power iteration, rho,
the ridge inverse); in a CV, the full fit's and every fold's (traced run,
synced at each edge)."""

SPANS = {"setup": [("admm_tpu_torch.models.lasso", "standardize"),
                   ("admm_tpu_torch.models.lasso", "_auto_lambdas"),
                   ("admm_tpu_torch.models.lasso", "_tall_setup"),
                   ("admm_tpu_torch.models.lasso", "_wide_setup")]}


def read(ctx):
    return ctx.span_ms_per_call("setup")
