from .mltps import LayerResult, MLTPSConfig, mltps, predict_over_stack

__all__ = ["LayerResult", "MLTPSConfig", "mltps", "predict_over_stack"]
