from repro_torch.data.pipeline import SyntheticTokens, make_batches  # noqa: F401
