"""Strict-key configuration dict.

Re-implements the behavior of the reference's ``Config``
(metadrive/utils/config.py:69-324): unknown keys raise, updates recurse into
nested dicts, and a config can be frozen (``unchangeable``). This package
keeps the same ergonomics so user configs port over unchanged.
"""
import copy


class Config(dict):
    def __init__(self, data=None, unchangeable: bool = False):
        super().__init__()
        self._unchangeable = False
        data = data or {}
        for k, v in dict(data).items():
            if isinstance(v, dict) and not isinstance(v, Config):
                v = Config(v)
            super().__setitem__(k, v)
        self._unchangeable = unchangeable

    # -- dict protocol with strict keys ------------------------------------
    def __getitem__(self, key):
        if key not in self.keys():
            raise KeyError(f"'{key}' does not exist in config. Existing keys: {list(self.keys())}")
        return super().__getitem__(key)

    def __setitem__(self, key, value):
        if getattr(self, "_unchangeable", False):
            raise ValueError(f"Config is frozen; cannot set '{key}'")
        if key not in self.keys():
            raise KeyError(f"'{key}' does not exist in config. Existing keys: {list(self.keys())}")
        if isinstance(value, dict) and not isinstance(value, Config):
            value = Config(value)
        super().__setitem__(key, value)

    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)
        try:
            return self[item]
        except KeyError as e:
            raise AttributeError(item) from e

    # -- reference-compatible API ------------------------------------------
    def update(self, new_dict, allow_add_new_key: bool = False, stop_recursive_update=()):
        """Recursive update; unknown keys raise unless allow_add_new_key.

        Mirrors metadrive/utils/config.py Config.update semantics.
        """
        if new_dict is None:
            return self
        for k, v in dict(new_dict).items():
            if k not in self.keys():
                if not allow_add_new_key:
                    raise KeyError(
                        f"'{k}' does not exist in existing config. "
                        f"Please use config.update(..., allow_add_new_key=True) to add new keys. "
                        f"Existing keys: {list(self.keys())}"
                    )
                self.force_set(k, Config(v) if isinstance(v, dict) and not isinstance(v, Config) else v)
            else:
                existing = super().__getitem__(k)
                if (
                    isinstance(existing, Config) and isinstance(v, dict)
                    and k not in stop_recursive_update
                ):
                    existing.update(v, allow_add_new_key=allow_add_new_key)
                else:
                    self.force_set(k, Config(v) if isinstance(v, dict) and not isinstance(v, Config) else v)
        return self

    def force_set(self, key, value):
        super().__setitem__(key, value)

    def copy(self, unchangeable=None):
        ret = Config(copy.deepcopy(self.to_dict()))
        ret._unchangeable = self._unchangeable if unchangeable is None else unchangeable
        return ret

    def to_dict(self):
        out = {}
        for k in self.keys():
            v = super().__getitem__(k)
            out[k] = v.to_dict() if isinstance(v, Config) else v
        return out

    def freeze(self):
        self._unchangeable = True
        for v in self.values():
            if isinstance(v, Config):
                v.freeze()

    # internal attribute passthrough
    def __setattr__(self, key, value):
        if key.startswith("_"):
            object.__setattr__(self, key, value)
        else:
            self[key] = value
