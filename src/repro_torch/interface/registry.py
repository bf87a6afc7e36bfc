"""Scheme registries for the core-interface pipeline.

Three registries, one per pipeline stage:

  ARBITERS      output-interface arbitration policies (`core/arbiter.py`)
  CAM_VARIANTS  input-interface CAM circuit variants (`core/cam.py`)
  NOC_SCHEMES   inter-core transport schemes (`noc/router.py`)

The registry replaces the string-``if`` scheme dispatch that used to live
inside the hot paths: a scheme name is resolved to an *entry* object once
(at config-validation / trace time), and from then on everything is a
plain attribute access on the entry.  New schemes plug in through
``register_*`` without editing the fabric, the router, or the session.

This module is intentionally dependency-free (no torch, no package imports)
so that any layer — core, noc, interface — can import it without cycles.
Entry objects are defined next to the code they dispatch to and passed in
opaquely; the registry neither inspects nor constrains them beyond the
name they are registered under.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple


class SchemeRegistry:
    """A named mapping of scheme name -> entry with helpful failures."""

    def __init__(self, kind: str):
        """kind: human-readable scheme family name, used in error text."""
        self.kind = kind
        self._entries: Dict[str, Any] = {}

    def register(self, name: str, entry: Any, *, overwrite: bool = False) -> Any:
        """Bind ``name`` to an opaque entry object and return the entry.

        Raises:
          ValueError: on an empty/non-str name, or when ``name`` is
            already registered and ``overwrite`` is False (replacing a
            scheme must be an explicit decision - tests that shadow a
            builtin pass ``overwrite=True`` and restore it after).
        """
        if not isinstance(name, str) or not name:
            raise ValueError(f"{self.kind} scheme name must be a non-empty str")
        if name in self._entries and not overwrite:
            raise ValueError(
                f"{self.kind} scheme {name!r} is already registered; "
                f"pass overwrite=True to replace it")
        self._entries[name] = entry
        return entry

    def unregister(self, name: str) -> None:
        """Remove ``name`` if present; unknown names are a no-op."""
        self._entries.pop(name, None)

    def get(self, name: str) -> Any:
        """Resolve ``name`` to its entry.

        Raises:
          KeyError: on an unknown name; the message lists every
            registered scheme of this kind, so a typo'd config fails
            with the valid choices in hand.
        """
        try:
            return self._entries[name]
        except KeyError:
            raise KeyError(
                f"unknown {self.kind} scheme {name!r}; registered: "
                f"{', '.join(self.names()) or '(none)'}") from None

    def names(self) -> Tuple[str, ...]:
        """All registered scheme names, sorted (stable for error text)."""
        return tuple(sorted(self._entries))

    def __contains__(self, name: str) -> bool:
        """Membership test: ``"hier_tree" in ARBITERS``."""
        return name in self._entries

    def __iter__(self):
        """Iterate registered names in sorted order."""
        return iter(self.names())

    def __len__(self) -> int:
        """Number of registered schemes."""
        return len(self._entries)


ARBITERS = SchemeRegistry("arbiter")
CAM_VARIANTS = SchemeRegistry("CAM variant")
NOC_SCHEMES = SchemeRegistry("NoC")


def register_arbiter(name: str, entry: Any, *, overwrite: bool = False) -> Any:
    """Register an arbitration policy (see `repro_torch.core.arbiter.ArbiterScheme`)."""
    return ARBITERS.register(name, entry, overwrite=overwrite)


def register_cam_variant(name: str, entry: Any, *, overwrite: bool = False) -> Any:
    """Register a CAM circuit variant (see `repro_torch.core.cam.CamVariant`)."""
    return CAM_VARIANTS.register(name, entry, overwrite=overwrite)


def register_noc_scheme(name: str, entry: Any, *, overwrite: bool = False) -> Any:
    """Register a transport scheme (see `repro_torch.noc.router.NocScheme`)."""
    return NOC_SCHEMES.register(name, entry, overwrite=overwrite)


def get_arbiter(name: str) -> Any:
    """Resolve an arbiter scheme name (KeyError lists valid names)."""
    return ARBITERS.get(name)


def get_cam_variant(name: str) -> Any:
    """Resolve a CAM variant name (KeyError lists valid names)."""
    return CAM_VARIANTS.get(name)


def get_noc_scheme(name: str) -> Any:
    """Resolve a NoC scheme name (KeyError lists valid names)."""
    return NOC_SCHEMES.get(name)
