"""Dense decoder LM: layers, attention, transformer block, full model."""
