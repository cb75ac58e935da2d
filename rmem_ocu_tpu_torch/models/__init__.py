from rmem_ocu_tpu_torch.models.vos_model import VOSModel, build_vos_model  # noqa: F401
