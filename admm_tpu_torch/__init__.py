"""admm_tpu_torch — the PyTorch/CUDA port of ``admm_tpu``.

A second package beside the JAX one, for one NVIDIA H100.  It holds the
reference's five exports, the Lasso/Elastic-Net lambda path (tall and
wide, "scan" and "batch"), LAD and quantile regression, Basis Pursuit
(one signal or a batch) and the Dantzig selector, the penalized GLM
paths (logistic, Huber, Poisson and the family objects), with glmnet's
per-coordinate options (penalty factors, coefficient limits, ``exclude``,
``dfmax``/``pmax``), the adaptive lasso, the wide active-set path, the
(sparse-)group, generalized/fused, constrained/zero-sum and relaxed
lasso, the square-root, quantile, SLOPE, SVM, multi-task and
multinomial paths, the graphical lasso, robust PCA and matrix completion,
the Cox paths and their survival curves, the glmnet front end
(``glmnet``, ``cv_glmnet``, ``big_glm``), k-fold cross-validation of all
of these, consensus ADMM over row blocks on one device (the 13
``parallel_*`` drivers and the builders' ``.parallel(nthread)``,
:mod:`admm_tpu_torch.parallel`),
per-iteration residual traces (``trace_len``, ``.opts(trace=...)``,
:mod:`admm_tpu_torch.diag`), ``predict``/``coef``, the path summary,
``assess``/``roc``/``confusion``/``c_index``, the fit plots
(``fit.plot()``, :mod:`admm_tpu_torch.plotting`) and ``make_x``.  All six of the
JAX package's Pallas TPU kernels are hand-written CUDA kernels here
(``csrc/``, built with ``nvcc`` at first use)::

    import admm_tpu_torch
    fit = admm_tpu_torch.admm_lasso(x, y).fit()          # on "cuda"
    fit = admm_tpu_torch.admm_lasso(x, y, device="cpu").fit()
    fit.beta          # sparse (p+1) x nlambda, intercepts in row 0
    admm_tpu_torch.admm_lasso(x, y).parallel(2).fit()    # consensus ADMM
    admm_tpu_torch.admm_lad(x, y).fit().beta             # dense, intercept first
    admm_tpu_torch.admm_bp(A, b).fit().beta              # sparse (p, 1)
    admm_tpu_torch.logistic_lasso_path(x, labels).coef   # (nlambda, p) tensor
    cv = admm_tpu_torch.cv_lasso_path(x, y)              # 10 folds
    admm_tpu_torch.predict(cv, xnew, lam="lambda.min")   # numpy

Public names and call signatures are the JAX package's; ``device`` says
where numpy inputs go.  The GLM paths take ``dtype`` (float32 by default,
the kernel's precision).  LAD and BP take ``dtype``: None means
``torch.float32`` (the kernels' precision, eps 2e-5), ``torch.float64``
the reference's double precision (the generic engine, eps 1e-4).
"""
from __future__ import annotations

from .api import (ADMMBP, ADMMLAD, ADMMBPFit, ADMMDantzig, ADMMEnet,
                  ADMMLADFit, ADMMLasso, ADMMLassoFit, admm_bp, admm_dantzig,
                  admm_enet, admm_lad, admm_lasso)
from .assess import assess, c_index, confusion, roc
from .data.makex import make_x
from .data.standardize import StdStats
from .glmnet import big_glm, cv_glmnet, glmnet
from .models.bp import BPResult, bp_fit, bp_fit_batch
from .models.conlasso import constrained_lasso_path, zerosum_lasso_path
from .models.cox import cox_lasso_path, cv_cox_path, survfit_cox
from .models.cv import (CVResult, cv_constrained_lasso_path,
                        cv_dantzig_path, cv_enet_path, cv_fused_lasso_path,
                        cv_gen_lasso_path, cv_glm_path, cv_group_lasso_path,
                        cv_lasso_path, cv_logistic_path,
                        cv_multinomial_path, cv_multitask_lasso_path,
                        cv_slope_path, cv_sqrt_lasso_path,
                        cv_zerosum_lasso_path)
from .models.dantzig import dantzig_path
from .models.genlasso import (difference_matrix, difference_matrix_2d,
                              fused_lasso_path, gen_lasso_path)
from .models.glasso import (cv_glasso_path, empirical_covariance,
                            glasso_path, partial_correlations)
from .models.grouplasso import group_lasso_path
from .models.glm import (GLMFamily, binomial, binomial_cloglog,
                         binomial_probit, gamma_log, glm_lasso_path, huber,
                         huber_lasso_path, negative_binomial, poisson,
                         poisson_lasso_path)
from .models.lad import LADResult, lad_fit, quantile_fit
from .models.lasso import (PathResult, adaptive_lasso_path, enet_path,
                           lasso_path)
from .models.logistic import logistic_lasso_path
from .models.multinomial import MNPathResult, multinomial_lasso_path
from .models.multitask import (MTPathResult, multitask_lasso_path,
                               multitask_nuclear_path)
from .models.quantile import (QuantilePathResult, cv_quantile_lasso_path,
                              pinball_loss, quantile_lasso_path)
from .models.rpca import cv_rpca, matrix_complete, rpca, rpca_path
from .models.relaxed import (RelaxedPathResult, cv_relaxed_lasso_path,
                             relaxed_lasso_path)
from .models.slope import bh_sequence, slope_path
from .models.sqrtlasso import sqrt_lasso_path
from .models.svm import (CVSVMResult, SVMResult, cv_svm_path, svm_fit,
                         svm_path)
from .parallel.consensus import (parallel_bp_fit,
                                 parallel_constrained_lasso_path,
                                 parallel_enet_path, parallel_glm_lasso_path,
                                 parallel_group_lasso_path,
                                 parallel_huber_lasso_path,
                                 parallel_lasso_path,
                                 parallel_logistic_lasso_path,
                                 parallel_multinomial_lasso_path,
                                 parallel_multitask_lasso_path,
                                 parallel_poisson_lasso_path,
                                 parallel_slope_path,
                                 parallel_zerosum_lasso_path)
from .predict import coef, predict
from .summary import PathTable, deviance, format_path_table, path_table

__version__ = "0.4.0"

__all__ = [
    "admm_lasso", "admm_enet", "admm_lad", "admm_bp", "admm_dantzig",
    "ADMMLasso", "ADMMEnet", "ADMMLAD", "ADMMBP", "ADMMDantzig",
    "ADMMLassoFit", "ADMMLADFit", "ADMMBPFit",
    "lasso_path", "enet_path", "adaptive_lasso_path", "lad_fit",
    "quantile_fit", "bp_fit", "bp_fit_batch", "dantzig_path",
    "glm_lasso_path", "logistic_lasso_path", "huber_lasso_path",
    "poisson_lasso_path", "GLMFamily", "binomial", "huber", "poisson",
    "binomial_probit", "binomial_cloglog", "gamma_log", "negative_binomial",
    "cv_lasso_path", "cv_enet_path", "cv_logistic_path", "cv_glm_path",
    "cv_dantzig_path", "group_lasso_path", "cv_group_lasso_path",
    "gen_lasso_path", "fused_lasso_path", "difference_matrix",
    "difference_matrix_2d", "cv_gen_lasso_path", "cv_fused_lasso_path",
    "constrained_lasso_path", "zerosum_lasso_path",
    "cv_constrained_lasso_path", "cv_zerosum_lasso_path",
    "relaxed_lasso_path", "cv_relaxed_lasso_path", "RelaxedPathResult",
    "sqrt_lasso_path", "cv_sqrt_lasso_path", "quantile_lasso_path",
    "cv_quantile_lasso_path", "pinball_loss", "slope_path", "bh_sequence",
    "cv_slope_path", "svm_path", "svm_fit", "cv_svm_path",
    "multitask_lasso_path", "multitask_nuclear_path",
    "cv_multitask_lasso_path", "multinomial_lasso_path",
    "cv_multinomial_path", "QuantilePathResult", "SVMResult", "CVSVMResult",
    "MTPathResult", "MNPathResult",
    "glasso_path", "cv_glasso_path", "empirical_covariance",
    "partial_correlations", "rpca", "matrix_complete", "rpca_path",
    "cv_rpca", "cox_lasso_path", "cv_cox_path", "survfit_cox", "glmnet",
    "cv_glmnet", "big_glm", "make_x",
    "parallel_lasso_path", "parallel_enet_path", "parallel_group_lasso_path",
    "parallel_slope_path", "parallel_constrained_lasso_path",
    "parallel_zerosum_lasso_path", "parallel_bp_fit",
    "parallel_glm_lasso_path", "parallel_logistic_lasso_path",
    "parallel_huber_lasso_path", "parallel_poisson_lasso_path",
    "parallel_multinomial_lasso_path", "parallel_multitask_lasso_path",
    "predict", "coef", "path_table",
    "format_path_table", "deviance", "assess", "roc", "confusion",
    "c_index", "PathResult", "LADResult", "BPResult", "CVResult",
    "PathTable", "StdStats", "__version__",
]
