"""Build artifacts and the lock-order pass the port's runtime reads.

``artifact`` is the versioned JSON envelope (the parallel queue executor
loads its conflict matrix through it). ``lock_order`` is the reference
package's static Pass 3 over the port's tree, with ``findings`` (the
finding and baseline plumbing): the runtime race witness
(``testing/race_witness``) cross-validates every lock edge it observes
against its graph. The accepted lock findings and the sanitizer's
waivers are ``lock_baseline.json`` and ``sanitizer_waivers.json`` here.
The reference's other analysis passes have no copy here.
"""
