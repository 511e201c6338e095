"""The port's native host library (the BVH builder and the PNG encoder),
built from src/tinyrt.cpp at first use and loaded with ctypes."""
