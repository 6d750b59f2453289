from .synthetic import DEFAULT_BANDS, STANDARD_COLUMNS, SyntheticStellarGrids, make_synthetic_grids

__all__ = ["SyntheticStellarGrids", "make_synthetic_grids", "DEFAULT_BANDS", "STANDARD_COLUMNS"]
