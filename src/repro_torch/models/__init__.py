from repro_torch.models.model import BlockSpec, Model, UnitSpec, build_plan  # noqa: F401
