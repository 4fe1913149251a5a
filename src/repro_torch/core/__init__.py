"""The paper's primary contribution as composable PyTorch: the 3-stage
RLHF pipeline (PPO with EMA collection and mixture training, checkpoint
and resume, asynchronous stage 3 on one device), LoRA, and the Hybrid
Engine on data-parallel meshes (counterpart of ``repro/core``)."""
from repro_torch.core import ema, experience, lora
from repro_torch.core.hybrid_engine import HybridEngine
from repro_torch.core.pipeline import RLHFEngine, RLHFPipeline, StageConfig
from repro_torch.core.ppo import PPOConfig, PPOTrainer
from repro_torch.core.replay import (AsyncConfig, ExperienceProducer,
                                     ReplayClosed, ReplayQueue,
                                     ReplayTimeout, RolloutBatch,
                                     WeightPublisher)

__all__ = ["ema", "experience", "lora", "HybridEngine", "RLHFEngine",
           "RLHFPipeline", "StageConfig", "PPOConfig", "PPOTrainer",
           "AsyncConfig", "ExperienceProducer", "ReplayClosed",
           "ReplayQueue", "ReplayTimeout", "RolloutBatch",
           "WeightPublisher"]
