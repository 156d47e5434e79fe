"""The model-serving stack of the port (counterpart of ``repro/models``):
transformer / MoE / SSM / hybrid architectures as ``nn.Module`` weights
and plain functions on tensors.

Dtypes are explicit, as in the reference: the model's dtype (bf16 by
default) for weights and activations, float32 for norms, router logits
and recurrent states.  Entry points run on the card unless the caller
passes ``device="cpu"``.
"""
