"""repro_torch.core — RecJPQ item embeddings and the retrieval engine."""
from repro_torch.core.api import (Embedding, EmbeddingConfig,  # noqa: F401
                                  make_embedding)
