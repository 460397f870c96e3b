"""Simulator-client evaluators (intact_tpu/envs/evaluators): connect to a policy
server, sweep checkpoints, run episodes, log intention/execution metrics. They
run on the simulator's host and import no websocket, msgpack, cv2 or PIL until
a call needs them."""
