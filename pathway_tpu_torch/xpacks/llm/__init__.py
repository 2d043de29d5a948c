"""The port's part of the live RAG stack (counterpart of
``pathway_tpu/xpacks/llm``): so far the local encoder embedder."""

from pathway_tpu_torch.xpacks.llm import embedders

__all__ = ["embedders"]
