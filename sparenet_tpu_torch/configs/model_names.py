"""Model-type registry constants (reference: configs/model_names.py:4-12)."""

MODEL_SPARENET = "SpareNet"
MODEL_ATLASNET = "AtlasNet"
MODEL_MSN = "MSN"
MODEL_GRNET = "GRNet"

ALL_MODELS = (MODEL_SPARENET, MODEL_ATLASNET, MODEL_MSN, MODEL_GRNET)
