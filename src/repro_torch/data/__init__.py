from .pipeline import SyntheticTokenStream, batch_for_step, source_for_step

__all__ = ["SyntheticTokenStream", "batch_for_step", "source_for_step"]
