from . import embeddings

__all__ = ["embeddings"]
