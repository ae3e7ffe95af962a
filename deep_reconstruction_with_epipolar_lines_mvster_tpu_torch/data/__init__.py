"""Datasets and the batch loader of the port (numpy copies of the JAX
package's ``data/``).

``find_dataset_def`` is the registry of the reference
(datasets/__init__.py:5-8): it accepts the reference's module names
(``dtu_yao4``, ``blender4``, ``blendedmvs``, ``dataloader_eval``) and the
short names, so the shipped recipe scripts translate 1:1.
"""

from .loader import DataLoader, collate

_ALIASES = {
    "dtu_yao4": "dtu",
    "dtu": "dtu",
    "blender4": "blender",
    "blender": "blender",
    "blendedmvs": "blendedmvs",
    "dataloader_eval": "eval",
    "eval": "eval",
    "tanks": "tanks",
    "eth3d": "eth3d",
    "synthetic": "synthetic",
}


def find_dataset_def(name: str):
    key = _ALIASES.get(name)
    if key is None:
        raise KeyError(f"unknown dataset {name!r}; known: {sorted(_ALIASES)}")
    if key == "dtu":
        from .dtu import DTUDataset

        return DTUDataset
    if key == "blender":
        from .blender import BlenderDataset

        return BlenderDataset
    if key == "blendedmvs":
        from .blendedmvs import BlendedMVSDataset

        return BlendedMVSDataset
    if key == "eval":
        from .eval_loader import EvalDataset

        return EvalDataset
    if key == "tanks":
        from .tanks import TanksDataset

        return TanksDataset
    if key == "eth3d":
        from .eth3d import ETH3DDataset

        return ETH3DDataset
    from .synthetic import SyntheticTrainDataset

    return SyntheticTrainDataset


__all__ = ["DataLoader", "collate", "find_dataset_def"]
