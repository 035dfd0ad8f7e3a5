"""Federated runtime: local updates (eq. 3-5), aggregation (eq. 6), the
batch plan and the Algorithm-1 host loop (``FLTrainer``)."""
