"""Plain PyTorch references, one module per model family.

Each module gives ``weight_groups(hf)`` (the served weights under the
port's parameter names, grouped into few large seeded draws) and
``logits_at(weights, hf, seqs, quant=None)`` (float32 logits of each
sequence at the positions it asks for, the whole forward pass in float32
with TF32 off).  They import neither JAX nor anything of the program.
"""
