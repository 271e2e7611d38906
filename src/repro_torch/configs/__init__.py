from .base import (ArchConfig, Block, ShapeCell, SHAPES, ARCH_IDS,  # noqa
                   get_config, cell_applicable)
