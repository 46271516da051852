"""PyTorch/CUDA port of the embedding-lookup engine for one NVIDIA H100.

Importing the package builds nothing and imports no CUDA code: the kernels
under ``csrc/`` are compiled at their first launch on a CUDA tensor.
"""

from . import config, ops
from .config import (
    KAGGLE_TABLE_ROWS,
    Combiner,
    DLRMConfig,
    LookupImpl,
    MeshConfig,
    QueryConfig,
    ShardingPolicy,
    TableConfig,
    kaggle_config,
    loadgen_config,
    mlperf_dcnv2_config,
    random_config,
    toy_config,
)
from .convert import params_from_jax, quantized_params_from_jax, train_state_from_jax
from .device import resolve_device
from .entry import entry
from .models import (
    DLRM,
    bce_loss,
    fit,
    interact_dot,
    make_optimizer,
    make_train_step,
    quantize_dlrm_embeddings,
)
from .models.sparse_train import make_sparse_train_state, make_sparse_train_step
from .ops import embedding_bag, embedding_bag_fixedl, embedding_bag_fixedl_reference
from .parallel import (
    EmbeddingCollection,
    FusedLayout,
    HybridEmbeddingCollection,
    QuantizedEmbeddingCollection,
    plan,
    resolve_pack,
)

__all__ = [
    "KAGGLE_TABLE_ROWS", "Combiner", "DLRMConfig", "LookupImpl", "MeshConfig",
    "QueryConfig", "ShardingPolicy", "TableConfig", "kaggle_config",
    "loadgen_config", "mlperf_dcnv2_config", "random_config", "toy_config", "params_from_jax",
    "train_state_from_jax", "quantized_params_from_jax", "resolve_device", "entry",
    "DLRM", "bce_loss",
    "interact_dot", "fit", "make_optimizer", "make_train_step",
    "make_sparse_train_state", "make_sparse_train_step", "quantize_dlrm_embeddings",
    "embedding_bag_fixedl", "embedding_bag_fixedl_reference",
    "EmbeddingCollection", "FusedLayout", "HybridEmbeddingCollection",
    "QuantizedEmbeddingCollection", "plan",
    "resolve_pack", "config", "ops", "embedding_bag",
]

__version__ = "0.1.0"
