"""Embedding backends: the paper's workload layer (Fig. 1).

  dense  an ordinary learnable [vocab, dim] matrix (``DenseEmbedding``);
  hkv    the cache-semantic table as a dynamic embedding
         (``HKVEmbedding``): find_or_insert on the token batch, gradients
         applied through the updater role.
"""

from repro_torch.embedding import sparse_opt  # noqa: F401
from repro_torch.embedding.dense import DenseEmbedding  # noqa: F401
from repro_torch.embedding.dynamic import HKVEmbedding  # noqa: F401
from repro_torch.embedding.sparse_opt import SparseOptimizer  # noqa: F401
