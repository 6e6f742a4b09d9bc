"""Dense model slice: layers, attention, blocks and the model steps."""
