from repro_torch.serving.engine import (Completion, EngineCore,
                                        GenerationEngine, Request,
                                        SamplingParams, StepEvent)
from repro_torch.serving.generate import (decode_scan_step, decode_step,
                                          generate, prefill)
from repro_torch.serving.sampling import sample, sample_rows

__all__ = ["Completion", "EngineCore", "GenerationEngine", "Request",
           "SamplingParams", "StepEvent", "decode_scan_step", "decode_step",
           "generate", "prefill", "sample", "sample_rows"]
