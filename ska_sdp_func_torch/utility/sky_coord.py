"""Sky coordinate holder.

Counterpart of ska_sdp_func_tpu.utility.sky_coord (reference
utility/sdp_sky_coord.{h,c}: a type string, an epoch and up to three
values, sdp_sky_coord.h:36-106), used by phase rotation.
"""

from dataclasses import dataclass, field


@dataclass(frozen=True)
class SkyCoord:
    """Sky coordinate: type string, epoch, and up to three values (radians).

    For the "icrs"/"j2000" types used by phase rotation, ``coord0`` is the
    right ascension and ``coord1`` the declination, both in radians.
    """

    coord_type: str
    coord0: float
    coord1: float = 0.0
    coord2: float = 0.0
    epoch: float = field(default=2000.0)

    @property
    def ra(self) -> float:
        return self.coord0

    @property
    def dec(self) -> float:
        return self.coord1

    def value(self, dim: int) -> float:
        return (self.coord0, self.coord1, self.coord2)[dim]
