from repro_torch.simulator.hardware import (  # noqa: F401
    CHIME, DRAM_ONLY, FACIL, JETSON_ORIN_NX, Platform)
