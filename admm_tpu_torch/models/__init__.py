"""Model families (only the Lasso/Elastic-Net path is ported so far)."""
