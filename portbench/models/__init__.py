"""The models the benchmark runs, one module each, found by name as drivers
and metrics are: a configuration file (`configs/<config>.json`) names its
model under "model" beside "config" ("roitr" where it names none), and
`load` imports `portbench.models.<model>`. A model module provides:

- `reference_config(values)`: the reference's configuration from the
  file's values (derived values included);
- `make_state_dict(ref_cfg, seed, device)`: the weights from the seed,
  made on `device`, the same in every process;
- `build_reference(ref_cfg, state_dict, device)`: the plain reference
  model holding those weights;
- `program_config(values)`: the program's configuration from the same
  values (it imports the program when called, never when imported).

Importing a model module loads neither the program nor JAX.
"""

from __future__ import annotations

import importlib
import re
import types

DEFAULT = "roitr"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def load(name: str, config_file: str = "the configuration") -> types.ModuleType:
    """The module of the model `config_file` names."""
    if not (isinstance(name, str) and NAME.match(name) and name.isidentifier()):
        raise ValueError(f"{config_file} names the model {name!r}, which is not a model name")
    module = f"{__name__}.{name}"
    try:
        return importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        raise LookupError(f"{config_file} names the model {name!r}, and there is no "
                          f"portbench/models/{name}.py") from None


def weights(ctx) -> dict:
    """The seed's weights of the context's model, on the context's device."""
    return ctx.model.make_state_dict(ctx.ref_cfg, ctx.seed, ctx.device)
