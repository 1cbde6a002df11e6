from repro_torch.data.pipeline import SyntheticTokenStream, make_batch_iterator

__all__ = ["SyntheticTokenStream", "make_batch_iterator"]
