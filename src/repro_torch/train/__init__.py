"""Training-side support — the parts of ``repro.train`` the port carries
so far: CRC-checked checkpoints (``checkpoint``) and the host-side
straggler timer (``fault.StepTimer``).  The train loop, optimisers and
``GradMonitor`` come with ROADMAP.md queue 1 item 12."""
