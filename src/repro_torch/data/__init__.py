from repro_torch.data.pipeline import SyntheticLMData, SyntheticTTIData, make_batch_iterator

__all__ = ["SyntheticLMData", "SyntheticTTIData", "make_batch_iterator"]
