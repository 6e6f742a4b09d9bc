"""CXL simulator: the closure of ``core.tier`` (copies of the reference
package's ``sim`` modules; the vectorized engine and sweeps are not
needed by the port)."""
