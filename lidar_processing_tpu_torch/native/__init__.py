"""The host C++ module (chi-shape and convex hulls, union-find, radius CC,
serial FEC), built with g++ at first use; see ``_build.py``."""
