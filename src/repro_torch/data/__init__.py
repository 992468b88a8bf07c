"""Data pipeline: synthetic vector datasets, interval metadata generators
(the paper's Uniform/Normal/Skewed/Clustered/Hollow distributions plus an
uncapped real-world-style workload), selectivity-controlled query generation,
and exact ground truth."""
from repro_torch.data.synthetic import (
    INTERVAL_DISTRIBUTIONS,
    make_dataset,
    make_intervals,
    make_queries_vectors,
    make_vectors,
    validate_intervals,
)
from repro_torch.data.workloads import (
    QuerySet,
    generate_queries,
    ground_truth,
    recall_at_k,
)

__all__ = [
    "INTERVAL_DISTRIBUTIONS",
    "QuerySet",
    "generate_queries",
    "ground_truth",
    "make_dataset",
    "make_intervals",
    "make_queries_vectors",
    "make_vectors",
    "recall_at_k",
    "validate_intervals",
]
