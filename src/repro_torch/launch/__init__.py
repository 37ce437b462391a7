"""Launchers: serving (``serve``), training on one device or a mesh
(``train``), and the meshes and devices they run on (``mesh``)."""
