"""Mistral decoder, brain readout head, the VLB composition and weight conversion."""
