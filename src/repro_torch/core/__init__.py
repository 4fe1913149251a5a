"""The paper's primary contribution as composable PyTorch: the 3-stage
RLHF pipeline (PPO with EMA collection and mixture training, checkpoint
and resume) and LoRA on one device (counterpart of ``repro/core``).  The
Hybrid Engine and asynchronous RLHF are not yet ported."""
from repro_torch.core import ema, experience, lora
from repro_torch.core.pipeline import RLHFEngine, RLHFPipeline, StageConfig
from repro_torch.core.ppo import PPOConfig, PPOTrainer
from repro_torch.core.replay import RolloutBatch

__all__ = ["ema", "experience", "lora", "RLHFEngine", "RLHFPipeline",
           "StageConfig", "PPOConfig", "PPOTrainer", "RolloutBatch"]
