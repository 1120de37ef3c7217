"""repro_torch.core — RecJPQ item embeddings and the retrieval engine."""
from repro_torch.core.api import (Embedding, EmbeddingConfig,  # noqa: F401
                                  make_embedding)
# engine after the embeddings; semantic after engine: importing it
# registers the "semantic-id" scorer, so kind="semantic" specs resolve
# for every engine user
from repro_torch.core import engine  # noqa: F401,E402
from repro_torch.core import semantic  # noqa: F401,E402
