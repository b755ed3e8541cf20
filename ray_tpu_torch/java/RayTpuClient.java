// Java task-submission frontend for the ray_tpu_torch head.
//
// Ref analog: the reference's Java runtime
// (java/runtime/.../RayNativeRuntime.java:38) drives the shared
// CoreWorker over JNI (~32k LoC). Re-design: no JNI and no native
// library — this client speaks the head's framed wire protocol directly,
// exactly like the C++ frontend (ray_tpu_torch/native/task_client.cc):
// it emits the one fixed pickle shape the protocol needs (a (msg_type,
// request_id, bytes) tuple; core/protocol.py XLANG_CALL=67) and receives
// replies as RAW frames of JSON, so no pickle parser exists on the Java side.
// Submission is by function descriptor ("module:qualname"),
// python/ray/cross_language.py:15's pattern.
//
//   javac -d .build/ray_tpu_torch/java ray_tpu_torch/java/RayTpuClient.java
//   java -cp .build/ray_tpu_torch/java RayTpuClient <host:port> \
//       <module:qualname> '[1, 2]'
//
// The wire contract is task_client.cc's (the same two frame shapes).

import java.io.DataInputStream;
import java.io.DataOutputStream;
import java.io.IOException;
import java.net.Socket;
import java.nio.ByteBuffer;
import java.nio.ByteOrder;
import java.nio.charset.StandardCharsets;

public final class RayTpuClient implements AutoCloseable {
    private static final long RAW_BIT = 1L << 63;
    private static final int XLANG_CALL = 67; // core/protocol.py

    private final Socket sock;
    private final DataInputStream in;
    private final DataOutputStream out;

    public RayTpuClient(String host, int port) throws IOException {
        this.sock = new Socket(host, port);
        this.in = new DataInputStream(sock.getInputStream());
        this.out = new DataOutputStream(sock.getOutputStream());
    }

    /** Send one XLANG_CALL request (JSON body) and block for the reply. */
    public String call(String reqJson) throws IOException {
        sendFrame(pickleCall(XLANG_CALL, 1,
                             reqJson.getBytes(StandardCharsets.UTF_8)));
        byte[] raw = readRawFrame();
        return new String(raw, StandardCharsets.UTF_8);
    }

    /** Submit module:qualname(argsJson...) and block for the JSON reply. */
    public String submit(String function, String argsJson, String optionsJson)
            throws IOException {
        return call("{\"op\":\"submit\",\"function\":\"" + function
                + "\",\"args\":" + argsJson + ",\"options\":"
                + optionsJson + "}");
    }

    /** Create a named actor from module:Class; returns the JSON reply
     *  whose result carries the registered actor name. */
    public String actorCreate(String cls, String argsJson,
                              String optionsJson) throws IOException {
        return call("{\"op\":\"actor_create\",\"class\":\"" + cls
                + "\",\"args\":" + argsJson + ",\"options\":"
                + optionsJson + "}");
    }

    public String actorCall(String actor, String method, String argsJson)
            throws IOException {
        return call("{\"op\":\"actor_call\",\"actor\":\"" + actor
                + "\",\"method\":\"" + method + "\",\"args\":"
                + argsJson + "}");
    }

    public String actorKill(String actor) throws IOException {
        return call("{\"op\":\"actor_kill\",\"actor\":\"" + actor + "\"}");
    }

    // (int, int, bytes) tuple, pickle protocol 3 — see task_client.cc
    // for the opcode walkthrough (PROTO, BININT, SHORT_BINBYTES/BINBYTES,
    // TUPLE3, STOP).
    static byte[] pickleCall(int msgType, int requestId, byte[] payload) {
        int head = 2 + 5 + 5 + (payload.length < 256 ? 2 : 5);
        ByteBuffer buf = ByteBuffer.allocate(head + payload.length + 2)
                .order(ByteOrder.LITTLE_ENDIAN);
        buf.put((byte) 0x80).put((byte) 3);
        buf.put((byte) 'J').putInt(msgType);
        buf.put((byte) 'J').putInt(requestId);
        if (payload.length < 256) {
            buf.put((byte) 'C').put((byte) payload.length);
        } else {
            buf.put((byte) 'B').putInt(payload.length);
        }
        buf.put(payload);
        buf.put((byte) 0x87).put((byte) '.');
        byte[] outBytes = new byte[buf.position()];
        buf.flip();
        buf.get(outBytes);
        return outBytes;
    }

    private void sendFrame(byte[] payload) throws IOException {
        ByteBuffer hdr = ByteBuffer.allocate(8)
                .order(ByteOrder.LITTLE_ENDIAN);
        hdr.putLong(payload.length);
        out.write(hdr.array());
        out.write(payload);
        out.flush();
    }

    /** Skip pickled frames; return the first RAW frame's bytes. */
    private byte[] readRawFrame() throws IOException {
        while (true) {
            byte[] hdr = new byte[8];
            in.readFully(hdr);
            long len = ByteBuffer.wrap(hdr)
                    .order(ByteOrder.LITTLE_ENDIAN).getLong();
            boolean raw = (len & RAW_BIT) != 0;
            len &= ~RAW_BIT;
            byte[] body = new byte[(int) len];
            in.readFully(body);
            if (raw) {
                return body;
            }
            // pickled frame for some other consumer (pubsub etc.) — skip
        }
    }

    @Override
    public void close() throws IOException {
        sock.close();
    }

    public static void main(String[] args) throws Exception {
        if (args.length < 2) {
            System.err.println(
                "usage: RayTpuClient <host:port> <module:qualname> "
                + "[json-args] [json-options]\n"
                + "       RayTpuClient <host:port> actor-create "
                + "<module:Class> [json-args] [json-options]\n"
                + "       RayTpuClient <host:port> actor-call "
                + "<actor> <method> [json-args]\n"
                + "       RayTpuClient <host:port> actor-kill <actor>");
            System.exit(2);
        }
        String[] hp = args[0].replaceFirst("^tcp:", "").split(":");
        try (RayTpuClient client =
                 new RayTpuClient(hp[0], Integer.parseInt(hp[1]))) {
            String reply;
            switch (args[1]) {
                case "actor-create":
                    if (args.length < 3) {
                        System.err.println(
                            "actor-create needs <module:Class>");
                        System.exit(2);
                    }
                    reply = client.actorCreate(
                        args[2],
                        args.length > 3 ? args[3] : "[]",
                        args.length > 4 ? args[4] : "{}");
                    break;
                case "actor-call":
                    if (args.length < 4) {
                        System.err.println(
                            "actor-call needs <actor> <method>");
                        System.exit(2);
                    }
                    reply = client.actorCall(
                        args[2], args[3],
                        args.length > 4 ? args[4] : "[]");
                    break;
                case "actor-kill":
                    if (args.length < 3) {
                        System.err.println("actor-kill needs <actor>");
                        System.exit(2);
                    }
                    reply = client.actorKill(args[2]);
                    break;
                default:
                    reply = client.submit(
                        args[1],
                        args.length > 2 ? args[2] : "[]",
                        args.length > 3 ? args[3] : "{}");
            }
            System.out.println(reply);
            System.exit(reply.contains("\"status\": \"ok\"")
                        || reply.contains("\"status\":\"ok\"") ? 0 : 1);
        }
    }
}
