"""Build artifacts the port's runtime reads.

Only ``artifact`` (the versioned JSON envelope) is ported: the parallel
queue executor loads its conflict matrix through it. The reference
package's static-analysis passes are not ported.
"""
