"""musicgen-medium [audio] — 48L d_model=1536 24H (GQA kv=24) d_ff=6144
vocab=2048, decoder-only over EnCodec tokens.  [arXiv:2306.05284]

Frontend carve-out: the EnCodec/mel conv feature extractor is STUBBED, as
in the reference — the caller feeds precomputed frame embeddings at d_model
as ``embeds``
(``embed_inputs=False``); this module is the decoder transformer that
consumes them and predicts codec tokens (vocab 2048).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    arch_type="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    embed_inputs=False,
    logit_chunk=0,          # vocab is tiny; full logits are fine
)
