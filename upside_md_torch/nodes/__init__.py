"""Node library: importing this package registers every ported node type."""

from . import (affine, basic, env, hbond, hmm, membrane,  # noqa: F401
               nn, placement, radial, rama, rotamer, steric)
