"""python -m intact_tpu_torch.serve: a bare Pi0Policy over the websocket protocol."""

from intact_tpu_torch.serve.standalone import main

main()
