"""Training (counterpart of ``repro/training``): AdamW, TrainState, LR
schedules and the SFT / reward train steps."""
