from repro_torch.data.pipeline import (NeedleTask, SyntheticLMStream, calib_k_cache,
                                       make_needle_prompt)

__all__ = ["SyntheticLMStream", "NeedleTask", "make_needle_prompt", "calib_k_cache"]
