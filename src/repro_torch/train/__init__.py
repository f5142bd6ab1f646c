"""Training (port of ``repro.train``): the train step and loop
(``train_loop``) behind the ACE data filter and the ACE gradient monitor
(``fault.GradMonitor``, beside the host-side ``fault.StepTimer``), the
optimisers (``optim``), learning-rate schedules (``schedule``), int8
gradient compression with error feedback (``compression``) and
CRC-checked checkpoints (``checkpoint``)."""
