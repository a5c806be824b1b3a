from repro_torch.configs.odp_mach import IMAGENET, ODP, ExtremeTaskConfig

__all__ = ["ExtremeTaskConfig", "ODP", "IMAGENET"]
