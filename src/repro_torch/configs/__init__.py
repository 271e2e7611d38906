from .base import (ArchConfig, Block, ShapeCell, SHAPES, ARCH_IDS,  # noqa
                   get_config, cell_applicable, input_specs, make_inputs)
