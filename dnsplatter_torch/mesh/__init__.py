"""Meshing: TSDF fusion (dense and sparse), Poisson, the adaptive octree,
normal-weighted fusion, marching tetrahedra, post-processing and the
exporters."""
