from repro_torch.data.blending import DataBlender, stage_split
from repro_torch.data.datasets import (SYNTHETIC_DATASETS, ConstantTaskDataset,
                                       CopyTaskDataset, PromptDataset,
                                       SortTaskDataset)
from repro_torch.data.tokenizer import ByteTokenizer

__all__ = ["DataBlender", "stage_split", "SYNTHETIC_DATASETS",
           "CopyTaskDataset", "PromptDataset", "SortTaskDataset",
           "ConstantTaskDataset", "ByteTokenizer"]
