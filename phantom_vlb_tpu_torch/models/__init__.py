"""Mistral decoder, LoRA adapters, brain readout head, the VLB composition and weight conversion."""
