from repro_torch.models.model_api import ModelDef, build_model
