"""PLY point-cloud export (no external plyfile dependency).

The port's copy of the JAX package's ``eval/ply.py`` (numpy only).

Binary little-endian writer matching the reference's fused-cloud layout
(``test_mvs4.py:833-846``: float x/y/z + uchar red/green/blue vertex
elements) and an ascii writer mirroring ``utils.generate_pointcloud``
(utils.py:278-311).
"""

from __future__ import annotations

import numpy as np


def write_ply(path: str, xyz: np.ndarray, rgb_u8: np.ndarray | None = None) -> None:
    """xyz: [N, 3] float; rgb_u8: [N, 3] uint8 or None."""
    xyz = np.asarray(xyz, dtype="<f4")
    n = xyz.shape[0]
    with open(path, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
        header += ["property float x", "property float y", "property float z"]
        if rgb_u8 is not None:
            header += [
                "property uchar red", "property uchar green", "property uchar blue",
            ]
        header += ["end_header"]
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if rgb_u8 is None:
            xyz.tofile(f)
        else:
            rec = np.zeros(
                n,
                dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                       ("red", "u1"), ("green", "u1"), ("blue", "u1")],
            )
            rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
            rgb = np.asarray(rgb_u8, dtype=np.uint8)
            rec["red"], rec["green"], rec["blue"] = rgb[:, 0], rgb[:, 1], rgb[:, 2]
            rec.tofile(f)


def read_ply(path: str):
    """Minimal reader for the writer above (tests / round trips)."""
    with open(path, "rb") as f:
        props = []
        n = 0
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property"):
                props.append(tuple(line.split()[1:]))
            elif line == "end_header":
                break
        np_types = {"float": "<f4", "uchar": "u1"}
        dtype = [(name, np_types[t]) for t, name in props]
        rec = np.fromfile(f, dtype=np.dtype(dtype), count=n)
    xyz = np.stack([rec["x"], rec["y"], rec["z"]], axis=-1).astype(np.float32)
    if "red" in rec.dtype.names:
        rgb = np.stack([rec["red"], rec["green"], rec["blue"]], axis=-1)
        return xyz, rgb
    return xyz, None


def write_ply_ascii_colored(path: str, xyz: np.ndarray, rgb_u8: np.ndarray) -> None:
    """Ascii variant with alpha, mirroring utils.generate_pointcloud's header
    (utils.py:297-309)."""
    n = xyz.shape[0]
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\nelement vertex %d\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "property uchar alpha\nend_header\n" % n
        )
        for p, c in zip(xyz, rgb_u8):
            f.write(f"{p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]} 0\n")
