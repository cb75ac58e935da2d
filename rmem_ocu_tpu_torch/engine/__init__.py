from rmem_ocu_tpu_torch.engine.infer_engine import EngineState, InferEngine  # noqa: F401
