from repro_torch.serving.engine import (GREEDY, EngineMetrics,
                                        GenerationResult, Request,
                                        SamplingParams, ServeConfig,
                                        ServingEngine)

__all__ = ["GREEDY", "EngineMetrics", "GenerationResult", "Request",
           "SamplingParams", "ServeConfig", "ServingEngine"]
