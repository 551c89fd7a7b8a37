"""Node library: importing this package registers every ported node type."""

from . import (affine, basic, env, hbond, placement, rama,  # noqa: F401
               rotamer, steric)
