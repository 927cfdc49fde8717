"""LogisticRegression configuration.

Copy of ``multiverso_tpu/models/logreg/config.py`` on the port's
``io.TextReader``. Key=value config-file schema preserved from the
reference (ref: Applications/LogisticRegression/src/configure.h:10-103,
example/mnist.config). Unknown keys are ignored with a warning, like the
reference's map-based parser.
"""

from __future__ import annotations

from dataclasses import dataclass

from ...io import TextReader
from ...util import log


@dataclass
class Configure:
    input_size: int = 0
    output_size: int = 0
    sparse: bool = False
    train_epoch: int = 1
    minibatch_size: int = 20
    read_buffer_size: int = 2048
    show_time_per_sample: int = 10000
    regular_coef: float = 0.0005
    learning_rate: float = 0.8
    learning_rate_coef: float = 1e6
    # FTRL parameters (ref: configure.h:45-48)
    alpha: float = 0.005
    beta: float = 1.0
    lambda1: float = 5.0
    lambda2: float = 0.002
    init_model_file: str = ""
    train_file: str = "train.data"
    reader_type: str = "default"  # default / weight / bsparse
    test_file: str = ""
    output_model_file: str = "logreg.model"
    output_file: str = "logreg.output"
    use_ps: bool = False
    pipeline: bool = True
    sync_frequency: int = 1
    updater_type: str = "default"  # default / sgd / ftrl
    objective_type: str = "default"  # default / sigmoid / softmax / ftrl
    regular_type: str = "default"  # default / L1 / L2

    @classmethod
    def from_file(cls, path: str) -> "Configure":
        config = cls()
        reader = TextReader(path)
        while True:
            line = reader.get_line()
            if line is None:
                break
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, _, value = line.partition("=")
            key, value = key.strip(), value.strip()
            if not hasattr(config, key):
                log.info("logreg config: ignoring unknown key %s", key)
                continue
            current = getattr(config, key)
            if isinstance(current, bool):
                setattr(config, key,
                        value.lower() in ("true", "1", "yes", "on"))
            elif isinstance(current, int):
                setattr(config, key, int(float(value)))
            elif isinstance(current, float):
                setattr(config, key, float(value))
            else:
                setattr(config, key, value)
        reader.close()
        if config.objective_type == "ftrl":
            # FTRL implies sparse updater/storage (ref: ps_model.cpp:30-41).
            config.updater_type = "ftrl"
            config.sparse = True
        return config
