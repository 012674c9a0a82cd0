"""PLY export of reconstructions.

Port of ``cv_tpu/sfm/export.py`` (reference cv-sfm/src/export.rs): ASCII PLY
with ``vertex`` (xyz double + rgb uchar) and optional ``face`` elements;
cameras render as magenta pyramids of 4 triangles around the optical
center.  Host NumPy, and the same text as ``cv_tpu``'s, header comment
included, so equal inputs give equal bytes.
"""

from __future__ import annotations

import numpy as np

CAMERA_COLOR = (255, 0, 255)


def export_ply(path, points, colors, cameras, camera_faces: bool = True):
    vertices = []
    faces = []

    def add_vertex(p, c):
        vertices.append((float(p[0]), float(p[1]), float(p[2]), int(c[0]), int(c[1]), int(c[2])))
        return len(vertices) - 1

    for cam in cameras:
        oc = np.asarray(cam["optical_center"], float)
        up = np.asarray(cam["up_direction"], float)
        fwd = np.asarray(cam["forward_direction"], float)
        fl = float(cam["focal_length"])
        right = np.cross(fwd, up)
        center = add_vertex(oc, CAMERA_COLOR)
        corners = [
            add_vertex(oc + fwd * fl + u * up * fl + r * right * fl, CAMERA_COLOR)
            for u, r in [(1, 1), (1, -1), (-1, -1), (-1, 1)]
        ]
        ur, ul, dl, dr = corners
        if camera_faces:
            faces.append((center, dr, ur))
            faces.append((center, ur, ul))
            faces.append((center, ul, dl))
            faces.append((center, dl, dr))

    for p, c in zip(points, colors):
        add_vertex(p, c)

    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write("comment Exported from cv_tpu vslam-sandbox\n")
        f.write(f"element vertex {len(vertices)}\n")
        f.write("property double x\nproperty double y\nproperty double z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        if camera_faces:
            f.write(f"element face {len(faces)}\n")
            f.write("property list uchar int vertex_index\n")
        f.write("end_header\n")
        for x, y, z, r, g, b in vertices:
            f.write(f"{x} {y} {z} {r} {g} {b}\n")
        if camera_faces:
            for a, b3, c in faces:
                f.write(f"3 {a} {b3} {c}\n")
