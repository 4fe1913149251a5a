from repro_torch.data.tokenizer import ByteTokenizer

__all__ = ["ByteTokenizer"]
