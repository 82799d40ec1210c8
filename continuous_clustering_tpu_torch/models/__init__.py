"""The streaming step, host insertion and the ContinuousClustering facade."""
