"""Models: the ViT encoder and the transformer blocks it is built from."""
