"""Data preparation: glmnet-compatible standardization and recovery."""
