from repro_torch.data.pipeline import (
    TokenPipeline,
    pool_from_callable,
    shard_batch,
)
from repro_torch.data.selection import (
    BatchSelector,
    DashBatchSelector,
    pool_embeddings,
)
from repro_torch.data.synthetic import (
    make_d1_design,
    make_d1_regression,
    make_d3_classification,
    make_lm_tokens,
)

__all__ = [
    "BatchSelector",
    "DashBatchSelector",
    "TokenPipeline",
    "make_d1_design",
    "make_d1_regression",
    "make_d3_classification",
    "make_lm_tokens",
    "pool_embeddings",
    "pool_from_callable",
    "shard_batch",
]
