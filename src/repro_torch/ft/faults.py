"""`repro_torch.ft.faults`: deterministic fabric-layer fault models.

Port of `repro.ft.faults`.  `FaultModel` expresses hardware faults as
pure transforms, so a faulted run goes through the same session code as
a clean one and degrades instead of crashing:

  compile time  `apply_params` perturbs the routing state before the
                session builds its tables, routing index and kernel
                operands: ``corrupt_cam_entries`` distinct CAM slots get
                the tag of a random source (a mis-match that misroutes
                those synapses), then every CAM entry of a dead core is
                invalidated (it receives nothing).
  run time      `apply_spikes` masks dead cores' spikes (they emit
                nothing) and drops each event with probability
                ``drop_rate``.

The random draws differ from the JAX package's (torch cannot reproduce
``jax.random``'s threefry bits), but keep its properties:

  * the corrupted slots come from a `torch.Generator` seeded by ``seed``,
    on the CPU: exactly ``corrupt_cam_entries`` distinct slots;
  * the drop mask is a counter-based hash of (seed, lane, global tick,
    core, neuron), so a stream served in chunks draws exactly the faults
    of one uninterrupted run, lanes draw independently, and the CPU and
    the card draw the same bits.  Each key component goes through a
    32-bit multiply-xorshift finalizer (every value below 2^32, every
    product below 2^63, so int64 tensor arithmetic never overflows); an
    event is kept when the top 24 bits of its hash fall below
    ``round((1 - drop_rate) * 2^24)``.
"""

from __future__ import annotations

import dataclasses

import torch

_M32 = 0xFFFFFFFF
_HASH_MUL = 0x45D9F3B
_SEED_SALT = 0x5BD1E995
UNIT_BITS = 24


def _mix(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finalizer on int64 tensors holding values < 2^32."""
    x = ((x >> 16) ^ x) * _HASH_MUL & _M32
    x = ((x >> 16) ^ x) * _HASH_MUL & _M32
    return (x >> 16) ^ x


def keep_threshold(drop_rate: float) -> int:
    """Events whose 24-bit draw lies below this are kept."""
    return int(round((1.0 - drop_rate) * (1 << UNIT_BITS)))


def keep_mask(seed: int, lane: torch.Tensor, tick: torch.Tensor,
              frame: tuple, drop_rate: float) -> torch.Tensor:
    """(..., cores, n) bool keep mask of each event.

    lane and tick are int64 tensors of one shape (...): each entry's lane
    index and global tick.  The draw depends on (seed, lane, tick, core,
    neuron) alone.
    """
    cores, n = frame
    base = _mix(torch.full_like(tick, (int(seed) ^ _SEED_SALT) & _M32))
    key = _mix(_mix(base ^ (lane & _M32)) ^ (tick & _M32))
    pos = torch.arange(cores * n, dtype=torch.int64, device=tick.device)
    draw = _mix(_mix(key[..., None] ^ pos)) >> (32 - UNIT_BITS)
    keep = draw < keep_threshold(drop_rate)
    return keep.reshape(tick.shape + (cores, n))


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Deterministic, seeded fabric faults as pure transforms.

    dead_cores:          core indices that neither emit nor receive events.
    drop_rate:           per-event drop probability in [0, 1].
    corrupt_cam_entries: number of CAM slots whose stored tags are
                         re-randomized at compile time.
    seed:                seed of the corruption choice and the drop masks.
    """

    dead_cores: tuple = ()
    drop_rate: float = 0.0
    corrupt_cam_entries: int = 0
    seed: int = 0

    def __post_init__(self):
        cores = tuple(sorted(int(c) for c in self.dead_cores))
        if len(set(cores)) != len(cores):
            raise ValueError(f"dead_cores has duplicates: {cores}")
        if cores and cores[0] < 0:
            raise ValueError(f"dead_cores must be non-negative, got {cores}")
        object.__setattr__(self, "dead_cores", cores)
        if not 0.0 <= float(self.drop_rate) <= 1.0:
            raise ValueError(f"drop_rate must be in [0, 1], got {self.drop_rate}")
        object.__setattr__(self, "drop_rate", float(self.drop_rate))
        if int(self.corrupt_cam_entries) < 0:
            raise ValueError(f"corrupt_cam_entries must be >= 0, got {self.corrupt_cam_entries}")
        object.__setattr__(self, "corrupt_cam_entries", int(self.corrupt_cam_entries))
        object.__setattr__(self, "seed", int(self.seed))

    # ---- introspection ----------------------------------------------------

    @property
    def is_null(self) -> bool:
        """True when this model perturbs nothing (compiles as fault-free)."""
        return not self.dead_cores and self.drop_rate == 0.0 and self.corrupt_cam_entries == 0

    @property
    def perturbs_spikes(self) -> bool:
        """True when the run-time spike transform is non-trivial."""
        return bool(self.dead_cores) or self.drop_rate > 0.0

    def validate(self, cfg) -> None:
        """Check the model fits a fabric config; raise ValueError if not."""
        if self.dead_cores and max(self.dead_cores) >= cfg.cores:
            raise ValueError(
                f"dead core {max(self.dead_cores)} out of range for a "
                f"{cfg.cores}-core fabric"
            )
        total = cfg.cores * cfg.cam.entries
        if self.corrupt_cam_entries > total:
            raise ValueError(
                f"corrupt_cam_entries={self.corrupt_cam_entries} exceeds the "
                f"fabric's {total} CAM slots"
            )

    def describe(self) -> dict:
        """Small JSON-able summary for reports."""
        return {
            "dead_cores": list(self.dead_cores),
            "drop_rate": self.drop_rate,
            "corrupt_cam_entries": self.corrupt_cam_entries,
            "seed": self.seed,
        }

    # ---- compile-time transform ------------------------------------------

    def apply_params(self, params, cfg):
        """Perturbed copy of the routing state (`InterfaceParams`).

        Corruption happens *before* dead-core invalidation, so a corrupt
        slot landing on a dead core is still silenced: dead means dead.
        """
        from repro_torch.interface.types import int_to_bits

        tags, valid = params.tags, params.valid
        if self.corrupt_cam_entries:
            cores, entries = valid.shape
            gen = torch.Generator().manual_seed(self.seed)
            slots = torch.randperm(cores * entries,
                                   generator=gen)[:self.corrupt_cam_entries]
            bad_src = torch.randint(0, cfg.cores * cfg.neurons_per_core,
                                    (self.corrupt_cam_entries,), generator=gen)
            tag_bits = tags.shape[-1]
            tags = tags.reshape(cores * entries, tag_bits).clone()
            tags[slots.to(tags.device)] = int_to_bits(
                bad_src, tag_bits).to(tags.device, tags.dtype)
            tags = tags.reshape(params.tags.shape)
        if self.dead_cores:
            valid = valid.clone()
            valid[list(self.dead_cores)] = False
        return params._replace(tags=tags, valid=valid)

    # ---- run-time transform ----------------------------------------------

    def apply_spikes(self, spikes_tcn, tick0=0, lane=0) -> torch.Tensor:
        """Faulted copy of a (..., T, cores, n) spike stream.

        tick0: global tick index of each stream's first frame - an int or
        a tensor of the leading shape (...); lane: the lane index (same
        shapes) folded into the drop stream so lanes draw independent
        faults.
        """
        spikes = spikes_tcn if spikes_tcn.dtype == torch.bool else spikes_tcn > 0
        cores = spikes.shape[-2]
        if self.dead_cores:
            alive = torch.ones((cores,), dtype=torch.bool, device=spikes.device)
            alive[list(self.dead_cores)] = False
            spikes = spikes & alive[:, None]
        if self.drop_rate > 0.0:
            lead, ticks = spikes.shape[:-3], spikes.shape[-3]
            dev = spikes.device
            tick0 = torch.as_tensor(tick0, dtype=torch.int64).to(dev)
            lane = torch.as_tensor(lane, dtype=torch.int64).to(dev)
            t = torch.arange(ticks, dtype=torch.int64, device=dev)
            tick = tick0.expand(lead)[..., None] + t
            lanes = lane.expand(lead)[..., None].expand(tick.shape)
            spikes = spikes & keep_mask(self.seed, lanes, tick,
                                        tuple(spikes.shape[-2:]),
                                        self.drop_rate)
        return spikes
