"""Mesh types of the port: simplex (tri/tet) meshes and their point location."""
