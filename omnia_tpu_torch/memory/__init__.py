from omnia_tpu_torch.memory.embedding import TorchEmbedder

__all__ = ["TorchEmbedder"]
