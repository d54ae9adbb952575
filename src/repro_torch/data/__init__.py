"""Data pipelines in torch and numpy.  Counterpart of ``repro.data``:
the synthetic batches and input shapes (``synthetic``) and the packed
document pipeline (``packing``, numpy)."""
from repro_torch.data.synthetic import (input_specs, sample_batch,
                                        sample_decode_state, SHAPES,
                                        token_stream)

__all__ = ["input_specs", "sample_batch", "sample_decode_state", "SHAPES",
           "token_stream"]
